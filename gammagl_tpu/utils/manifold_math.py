"""Hyperbolic / spherical manifold operations (for RGT-style models).

Reference: gammagl/utils/manifold_math.py -- exp/log maps, Mobius addition,
curvature-parameterized distances on the Poincare ball and hypersphere.
"""

import jax.numpy as jnp

__all__ = ["mobius_add", "expmap", "logmap", "expmap0", "logmap0",
           "poincare_distance", "project"]

_EPS = 1e-7


def _lambda_x(x, c):
    return 2.0 / jnp.clip(1 - c * jnp.sum(x * x, -1, keepdims=True), _EPS)


def project(x, c, eps=1e-5):
    """Clip to the open Poincare ball of curvature -c."""
    norm = jnp.linalg.norm(x, axis=-1, keepdims=True).clip(_EPS)
    max_norm = (1 - eps) / jnp.sqrt(c)
    return jnp.where(norm > max_norm, x / norm * max_norm, x)


def mobius_add(x, y, c):
    """Mobius addition on the Poincare ball."""
    xy = jnp.sum(x * y, -1, keepdims=True)
    x2 = jnp.sum(x * x, -1, keepdims=True)
    y2 = jnp.sum(y * y, -1, keepdims=True)
    num = (1 + 2 * c * xy + c * y2) * x + (1 - c * x2) * y
    den = 1 + 2 * c * xy + c * c * x2 * y2
    return num / jnp.clip(den, _EPS)


def expmap(v, x, c):
    """Exponential map of tangent vector v at point x."""
    v_norm = jnp.linalg.norm(v, axis=-1, keepdims=True).clip(_EPS)
    sc = jnp.sqrt(c)
    second = jnp.tanh(sc * _lambda_x(x, c) * v_norm / 2) * v / (sc * v_norm)
    return project(mobius_add(x, second, c), c)


def logmap(y, x, c):
    """Logarithm map of y at base point x."""
    sub = mobius_add(-x, y, c)
    sub_norm = jnp.linalg.norm(sub, axis=-1, keepdims=True).clip(_EPS)
    sc = jnp.sqrt(c)
    return (2 / (sc * _lambda_x(x, c)) * jnp.arctanh(
        jnp.clip(sc * sub_norm, 0, 1 - _EPS)) * sub / sub_norm)


def expmap0(v, c):
    """Exp map at the origin."""
    v_norm = jnp.linalg.norm(v, axis=-1, keepdims=True).clip(_EPS)
    sc = jnp.sqrt(c)
    return project(jnp.tanh(sc * v_norm) * v / (sc * v_norm), c)


def logmap0(y, c):
    y_norm = jnp.linalg.norm(y, axis=-1, keepdims=True).clip(_EPS)
    sc = jnp.sqrt(c)
    return jnp.arctanh(jnp.clip(sc * y_norm, 0, 1 - _EPS)) * y / (
        sc * y_norm)


def poincare_distance(x, y, c):
    sc = jnp.sqrt(c)
    add = mobius_add(-x, y, c)
    return 2 / sc * jnp.arctanh(
        jnp.clip(sc * jnp.linalg.norm(add, axis=-1), 0, 1 - _EPS))




def _safe_norm(x, axis=-1, keepdims=True, eps=1e-12):
    """L2 norm whose gradient is finite at x == 0 (jnp.linalg.norm's VJP is
    NaN there, and `where`/`maximum` do not stop NaNs from the untaken
    branch -- this bites on zero-padded node rows)."""
    return jnp.sqrt(jnp.sum(x * x, axis=axis, keepdims=keepdims) + eps)


# ---------------------------------------------------------------------------
# Constant-curvature manifold objects (RGT family).
#
# Reference: gammagl/layers/conv/rgt_layers.py:40-452 wraps geoopt manifolds
# (Euclidean:40, ProductSpace:95, Sphere:151, Lorentz:291) in stateful torch
# modules whose Frechet_mean computes `num_segments` on the host
# (rgt_layers.py:384-398) -- a sync point every layer. The re-design makes
# each manifold a frozen, hashable value object (safe as a static module
# field) whose methods are pure jnp with *static* segment counts, so the whole
# RGT forward stays inside one XLA program. Distances to code-books reduce to
# batched GEMMs (cinner).
# ---------------------------------------------------------------------------


class _Manifold:
    """Base: hashable by (type, curvature) so a module field treats it as static."""

    k = 1.0

    def __eq__(self, other):
        return type(self) is type(other) and self.k == other.k

    def __hash__(self):
        return hash((type(self).__name__, self.k))

    # shared helper: renormalize an ambient vector onto the manifold the way
    # the reference's Frechet_mean does (rgt_layers.py:384-398): z / sqrt(k)
    # divided by the |self-inner| norm.
    def _renorm(self, z, eps=1e-8):
        denorm = jnp.sqrt(jnp.maximum(jnp.abs(self.inner(None, z, keepdim=True)), eps))
        return z / (jnp.sqrt(self.k) * denorm)

    def frechet_mean(self, x, sum_idx, num_segments, weights=None):
        """Segment centroid projected back to the manifold.

        `num_segments` is static (the reference derives it from a host-side
        reduce_max -- rgt_layers.py:386-388 -- which would force a sync
        under jit)."""
        from gammagl_tpu.ops.segment import unsorted_segment_sum
        if weights is not None:
            x = x * weights
        z = unsorted_segment_sum(x, sum_idx, num_segments)
        return self._renorm(z)


class EuclideanM(_Manifold):
    """Flat manifold (reference rgt_layers.py:40-93). Frechet mean is the
    plain segment mean; exp/log maps are identity."""

    name = "euclidean"

    def expmap0(self, v):
        return v

    def logmap0(self, v):
        return v

    def proju(self, x, u):
        return u

    def proju0(self, v):
        return v

    def projx(self, x):
        return x

    def transp0back(self, x, u):
        return u

    def inner(self, x, u, v=None, keepdim=False):
        v = u if v is None else v
        return jnp.sum(u * v, -1, keepdims=keepdim)

    def cinner(self, x, y):
        if x.shape == y.shape:
            return jnp.sum(x * y, -1, keepdims=True)
        return x @ jnp.swapaxes(y, -1, -2)

    def norm(self, u, x=None, keepdim=False):
        n = _safe_norm(u)
        return n if keepdim else n[..., 0]

    def dist(self, x, y, keepdim=False):
        n = _safe_norm(x - y)
        return n if keepdim else n[..., 0]

    def frechet_mean(self, x, sum_idx, num_segments, weights=None):
        from gammagl_tpu.ops.segment import unsorted_segment_mean
        if weights is not None:
            x = x * weights
        return unsorted_segment_mean(x, sum_idx, num_segments)


class SphereM(_Manifold):
    """Unit hypersphere, pole at -e0 (reference rgt_layers.py:151-289)."""

    name = "sphere"

    def origin_like(self, x):
        o = jnp.zeros_like(x)
        return o.at[..., 0].set(-1.0)

    def proju(self, x, u):
        return u - jnp.sum(x * u, -1, keepdims=True) * x

    def proju0(self, u):
        return self.proju(self.origin_like(u), u)

    def projx(self, x):
        return x / _safe_norm(x, eps=_EPS * _EPS)

    def inner(self, x, u, v=None, keepdim=False):
        v = u if v is None else v
        return jnp.sum(u * v, -1, keepdims=keepdim)

    def cinner(self, x, y):
        if x.shape == y.shape:
            return jnp.sum(x * y, -1, keepdims=True)
        return x @ jnp.swapaxes(y, -1, -2)

    def norm(self, u, x=None, keepdim=False):
        n = _safe_norm(u)
        return n if keepdim else n[..., 0]

    def expmap(self, x, u):
        # grad-safe norm makes sin(nu)/nu smooth at u=0, so no retraction
        # fallback branch is needed (x*cos(eps) + u*sinc -> x).
        nu = _safe_norm(u)
        return x * jnp.cos(nu) + u * jnp.sin(nu) / nu

    def expmap0(self, u):
        return self.expmap(self.origin_like(u), u)

    def logmap(self, x, y):
        u = self.proju(x, y - x)
        d = self.dist(x, y, keepdim=True)
        nu = _safe_norm(u, eps=_EPS * _EPS)
        return u * d / nu

    def logmap0(self, y):
        return self.logmap(self.origin_like(y), y)

    def dist(self, x, y, keepdim=False):
        cos = jnp.clip(jnp.sum(x * y, -1, keepdims=keepdim) / self.k,
                       -1.0 + 1e-6, 1.0 - 1e-6)
        return jnp.sqrt(self.k) * jnp.arccos(cos)

    def pairwise_dist(self, x, codes):
        """(N,d) x (C,d) -> (N,C) geodesic distances: one GEMM + acos."""
        cos = jnp.clip((x @ codes.T) / self.k, -1.0 + 1e-6, 1.0 - 1e-6)
        return jnp.sqrt(self.k) * jnp.arccos(cos)

    def transp(self, x, y, u):
        return self.proju(y, self.proju(x, u))

    def transp0back(self, x, u):
        return self.transp(x, self.origin_like(x), u)


class LorentzM(_Manifold):
    """Hyperboloid model, time axis first (reference rgt_layers.py:291-452).
    <x,y>_L = -x0*y0 + <x_s,y_s>; points satisfy <x,x>_L = -k."""

    name = "lorentz"

    def origin_like(self, x):
        o = jnp.zeros_like(x)
        return o.at[..., 0].set(jnp.sqrt(self.k))

    def inner(self, x, u, v=None, keepdim=False):
        v = u if v is None else v
        flip = jnp.concatenate([-u[..., :1], u[..., 1:]], -1)
        return jnp.sum(flip * v, -1, keepdims=keepdim)

    def cinner(self, x, y):
        if x.shape == y.shape:
            return (jnp.sum(x[..., 1:] * y[..., 1:], -1, keepdims=True)
                    - x[..., :1] * y[..., :1])
        flip = jnp.concatenate([-x[..., :1], x[..., 1:]], -1)
        return flip @ jnp.swapaxes(y, -1, -2)

    def norm(self, u, x=None, keepdim=False):
        return jnp.sqrt(jnp.maximum(self.inner(None, u, keepdim=keepdim), 1e-8))

    def proju(self, x, u):
        # tangent projection: u + <x,u>_L / k * x
        return u + self.inner(x, x, u, keepdim=True) / self.k * x

    def proju0(self, v):
        return self.proju(self.origin_like(v), v)

    def projx(self, x):
        sp = jnp.sum(x[..., 1:] ** 2, -1, keepdims=True)
        t = jnp.sqrt(self.k + sp)
        return jnp.concatenate([t, x[..., 1:]], -1)

    def expmap(self, x, u):
        sk = jnp.sqrt(self.k)
        n = self.norm(u, keepdim=True)
        safe = jnp.maximum(n / sk, _EPS)
        return jnp.cosh(n / sk) * x + jnp.sinh(safe) / safe * u

    def expmap0(self, u):
        return self.expmap(self.origin_like(u), u)

    def logmap0(self, x):
        sk = jnp.sqrt(self.k)
        y = x[..., 1:]
        yn = _safe_norm(y, eps=1e-12)
        theta = jnp.maximum(x[..., :1] / sk, 1.0 + 1e-7)
        r = sk * jnp.arccosh(theta) * y / yn
        return jnp.concatenate([jnp.zeros_like(r[..., :1]), r], -1)

    def dist(self, x, y, keepdim=False):
        arg = jnp.maximum(-self.cinner(x, y) / self.k, 1.0 + 1e-5)
        d = jnp.sqrt(self.k) * jnp.arccosh(arg)
        return d if keepdim else jnp.squeeze(d, -1) if d.shape[-1] == 1 else d

    def pairwise_dist(self, x, codes):
        """(N,d) x (C,d) -> (N,C): the cinner is one GEMM."""
        flip = jnp.concatenate([-x[..., :1], x[..., 1:]], -1)
        arg = jnp.maximum(-(flip @ codes.T) / self.k, 1.0 + 1e-5)
        return jnp.sqrt(self.k) * jnp.arccosh(arg)

    def transp0back(self, x, u):
        # reflection through the tangent component of x at the origin
        # (reference rgt_layers.py:422-430)
        o = self.origin_like(x)
        xo = self.proju(o, x)
        num = self.inner(o, xo, u, keepdim=True)
        den = self.inner(o, xo, xo, keepdim=True) + 1e-8
        return u - 2.0 * num / den * xo


class ProductM:
    """Product of (manifold, dim) factors (reference rgt_layers.py:95-149):
    logmap0/proju0/frechet_mean apply factor-wise over feature slices."""

    def __init__(self, *factors):
        self.factors = tuple(factors)  # ((manifold, dim), ...)

    def __eq__(self, other):
        return isinstance(other, ProductM) and self.factors == other.factors

    def __hash__(self):
        return hash(self.factors)

    def _split(self, x):
        out, off = [], 0
        for m, d in self.factors:
            out.append((m, x[..., off:off + d]))
            off += d
        return out

    def logmap0(self, x):
        return jnp.concatenate([m.logmap0(p) for m, p in self._split(x)], -1)

    def proju0(self, v):
        return jnp.concatenate([m.proju0(p) for m, p in self._split(v)], -1)

    def expmap0(self, v):
        return jnp.concatenate([m.expmap0(p) for m, p in self._split(v)], -1)

    def frechet_mean(self, x, sum_idx, num_segments, weights=None):
        return jnp.concatenate(
            [m.frechet_mean(p, sum_idx, num_segments, weights)
             for m, p in self._split(x)], -1)


__all__ += ["EuclideanM", "SphereM", "LorentzM", "ProductM"]
