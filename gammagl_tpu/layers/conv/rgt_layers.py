"""RGT constant-curvature building blocks.

Reference: gammagl/layers/conv/rgt_layers.py:454-564 (EuclideanEncoder,
ManifoldEncoder, ConstCurveLinear, ConstCurveAgg). The reference's
ConstCurveLinear (rgt_layers.py:486-524) maps a Euclidean linear output onto
the manifold by rescaling the space part so the (time, space) pair lands
exactly on the hyperboloid / sphere; ConstCurveAgg (rgt_layers.py:526-563)
neighbor-sums then renormalizes onto the manifold. Both are elementwise
around one GEMM + one segment reduce, so XLA fuses each into a single
kernel pair; the segment reduce uses this framework's static-shape
unsorted_segment_sum (no host-derived segment counts).
"""

from gammagl_tpu import nn
import jax.numpy as jnp

from gammagl_tpu.ops.segment import unsorted_segment_sum
from gammagl_tpu.utils.manifold_math import LorentzM

__all__ = ["ConstCurveLinear", "ConstCurveAgg", "EuclideanEncoder",
           "ManifoldEncoder"]

_EPS = 1e-8


class ConstCurveLinear(nn.Module):
    """Linear map whose output is re-embedded on a constant-curvature
    manifold (reference rgt_layers.py:486-524). The first output channel
    becomes the time/pole coordinate; the rest are scaled so the point
    satisfies the manifold constraint analytically (no projection step)."""

    manifold: object
    in_features: int
    out_features: int
    bias: bool = True
    dropout: float = 0.0
    scale_init: float = 10.0
    activation: object = None

    @nn.compact
    def __call__(self, x, deterministic=True):
        if self.activation is not None:
            x = self.activation(x)
        if self.dropout > 0.0 and not deterministic:
            x = nn.Dropout(self.dropout, deterministic=False)(x)
        x = nn.Dense(self.out_features, use_bias=self.bias, name="weight")(x)
        log_scale = self.param("scale", lambda rng, s: jnp.full(s, jnp.log(self.scale_init)), (1,))
        space = x[..., 1:]
        if isinstance(self.manifold, LorentzM):
            time = nn.sigmoid(x[..., :1]) * jnp.exp(log_scale) + 1.1
            sign = -1.0
        else:
            time = nn.sigmoid(x[..., :1]) - 0.5
            sign = 1.0
        k = self.manifold.k
        sq = jnp.maximum(jnp.sum(space * space, -1, keepdims=True), _EPS)
        scale = sign * (1.0 / k - time * time) / sq
        return jnp.concatenate([time, space * jnp.sqrt(scale)], -1)


class ConstCurveAgg(nn.Module):
    """Neighborhood sum renormalized onto the manifold (reference
    rgt_layers.py:526-563). With `use_att`, edge weights are a sigmoid of
    the cross inner product (a gather + GEMM)."""

    manifold: object
    in_features: int
    dropout: float = 0.0
    use_att: bool = False

    @nn.compact
    def __call__(self, x, edge_index):
        src, dst = edge_index[0], edge_index[1]
        num_nodes = x.shape[0]
        sign = -1.0 if isinstance(self.manifold, LorentzM) else 1.0
        if self.use_att:
            query = ConstCurveLinear(self.manifold, self.in_features,
                                     self.in_features, name="query")(x)
            key = ConstCurveLinear(self.manifold, self.in_features,
                                   self.in_features, name="key")(x)
            bias = self.param("att_bias", nn.initializers.constant(20.0), (1,))
            scale = self.param("att_scale",
                               nn.initializers.constant(self.in_features ** 0.5), (1,))
            att = 2.0 + 2.0 * self.manifold.cinner(query[dst], key[src])
            att = nn.sigmoid(att / scale + bias)
            support = unsorted_segment_sum(att * x[dst], src, num_nodes)
        else:
            support = unsorted_segment_sum(x[dst], src, num_nodes)
        denorm = jnp.sqrt(jnp.maximum(
            jnp.abs(sign * self.manifold.inner(None, support, keepdim=True)), _EPS))
        return support / (jnp.sqrt(self.manifold.k) * denorm)


class EuclideanEncoder(nn.Module):
    """Two-layer MLP with L2-normalized output (reference
    rgt_layers.py:454-470)."""

    in_dim: int
    hidden_dim: int
    out_dim: int
    bias: bool = True
    activation: object = nn.relu
    dropout: float = 0.1

    @nn.compact
    def __call__(self, x, deterministic=True):
        x = nn.Dense(self.hidden_dim, use_bias=self.bias, name="lin")(x)
        if self.activation is not None:
            x = self.activation(x)
        if self.dropout > 0.0 and not deterministic:
            x = nn.Dropout(self.dropout, deterministic=False)(x)
        x = nn.Dense(self.out_dim, use_bias=self.bias, name="proj")(x)
        return x / jnp.sqrt(jnp.sum(x * x, -1, keepdims=True) + _EPS)


class ManifoldEncoder(nn.Module):
    """expmap0 -> curve-linear -> neighborhood aggregate (reference
    rgt_layers.py:472-484)."""

    manifold: object
    in_dim: int
    hidden_dim: int
    out_dim: int
    bias: bool = True
    activation: object = None
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, edge_index, deterministic=True):
        x = self.manifold.expmap0(x)
        x = ConstCurveLinear(self.manifold, self.in_dim, self.out_dim,
                             bias=self.bias, dropout=self.dropout,
                             activation=self.activation,
                             name="lin")(x, deterministic)
        return ConstCurveAgg(self.manifold, self.out_dim, name="agg")(x, edge_index)
