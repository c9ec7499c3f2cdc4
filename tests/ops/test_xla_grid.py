"""The XLA message-passing ops over a grid of graph shapes, forward and
gradient, against float64 numpy references.

Grid: reduce x dtype x graph case x feature width, where the cases are the
shapes that break scatter-based kernels: isolated destination rows, padded
edges (dst == N), duplicate edges, an empty edge list and power-law
in-degree. bf16 runs compare against the reference evaluated on the
bf16-rounded inputs, so only output rounding and the f32 accumulation
differ.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gammagl_tpu.ops import bspmm, sddmm, segment_softmax, spmm
from gammagl_tpu.ops.segment import accum_dtype

N = 40
CASES = ["isolated", "padded", "duplicates", "empty", "powerlaw"]
TOL = {jnp.float32: 1e-5, jnp.bfloat16: 2e-2}


def graph(case, seed=0, e=160):
    """(src, dst, w): int64 edges (dst may be N for pads), f32 weights."""
    rng = np.random.default_rng(seed)
    if case == "empty":
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32))
    src = rng.integers(0, N, e)
    if case == "isolated":
        dst = rng.integers(0, N - 10, e)          # rows N-10.. never hit
    elif case == "powerlaw":
        dst = (N * rng.random(e) ** 3).astype(np.int64)
    else:
        dst = rng.integers(0, N, e)
    w = rng.uniform(0.5, 1.5, e).astype(np.float32)
    if case == "duplicates":
        src, dst, w = (np.concatenate([a, a]) for a in (src, dst, w))
    if case == "padded":
        k = e // 4
        src = np.concatenate([src, rng.integers(0, N, k)])
        dst = np.concatenate([dst, np.full(k, N)])
        w = np.concatenate([w, rng.uniform(0.5, 1.5, k).astype(np.float32)])
    return src, dst, w


def _round(a, dtype):
    """float64 `a` rounded through `dtype` (the op's message dtype)."""
    return np.asarray(jnp.asarray(a, dtype).astype(jnp.float32), np.float64)


def ref_spmm(src, dst, w, x, reduce, dtype=jnp.float32):
    """float64 reduce over edges of w * x[src]; the messages are rounded
    to `dtype` first, as the op forms them."""
    x = np.asarray(x, np.float64)
    f = x.shape[1]
    valid = dst < N
    s, d, ww = src[valid], dst[valid], w[valid].astype(np.float64)
    msg = _round(x[s] * ww[:, None], dtype)
    deg = np.bincount(d, minlength=N).astype(np.float64)
    out = np.zeros((N, f))
    if reduce in ("sum", "mean"):
        np.add.at(out, d, msg)
        if reduce == "mean":
            out /= np.maximum(deg, 1)[:, None]
        return out
    fill = -np.inf if reduce == "max" else np.inf
    out[:] = fill
    (np.maximum if reduce == "max" else np.minimum).at(out, d, msg)
    out[np.isinf(out)] = 0.0
    return out


def ref_spmm_grads(src, dst, w, x, reduce, ct, dtype=jnp.float32):
    """Gradients of sum(out * ct) w.r.t. x and w (max/min: ties split
    evenly, the subgradient XLA's scatter-max VJP takes)."""
    x = np.asarray(x, np.float64)
    ct = np.asarray(ct, np.float64)
    gx = np.zeros_like(x)
    gw = np.zeros(len(src))
    valid = dst < N
    deg = np.bincount(dst[valid], minlength=N).astype(np.float64)
    out = ref_spmm(src, dst, w, x, reduce, dtype)
    for e in np.nonzero(valid)[0]:
        s, d, we = src[e], dst[e], float(w[e])
        if reduce in ("sum", "mean"):
            scale = 1.0 if reduce == "sum" else 1.0 / deg[d]
            gx[s] += scale * we * ct[d]
            gw[e] = scale * np.dot(ct[d], x[s])
        else:
            msg = _round(we * x[s], dtype)
            hit = msg == out[d]
            ties = np.zeros(x.shape[1])
            for e2 in np.nonzero(valid & (dst == d))[0]:
                ties += _round(float(w[e2]) * x[src[e2]], dtype) == out[d]
            share = np.where(hit, ct[d] / np.maximum(ties, 1), 0.0)
            gx[s] += we * share
            gw[e] = np.dot(share, x[s])
    return gx, gw


def norm_err(got, want):
    got = np.asarray(jnp.asarray(got, jnp.float32), np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("f", [1, 7, 64, 256])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
def test_spmm_grid(reduce, dtype, case, f):
    src, dst, w = graph(case, seed=f)
    rng = np.random.default_rng(f + 1)
    x = jnp.asarray(rng.normal(size=(N, f)), dtype)
    wj = jnp.asarray(w, dtype)
    ei = jnp.asarray(np.stack([src, dst]).astype(np.int32))
    ct = rng.normal(size=(N, f)).astype(np.float32)

    def loss(x, w):
        out = spmm(ei, w, x, num_nodes=N, reduce=reduce)
        return (out.astype(jnp.float32) * ct).sum(), out

    (_, out), (gx, gw) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(x, wj)
    assert out.shape == (N, f) and out.dtype == dtype
    # the reference sees exactly the (rounded) inputs the op saw
    x64 = np.asarray(x.astype(jnp.float32), np.float64)
    w64 = np.asarray(wj.astype(jnp.float32), np.float64)
    want = ref_spmm(src, dst, w64, x64, reduce, accum_dtype(dtype))
    assert norm_err(out, want) <= TOL[dtype]
    if case == "isolated":
        assert not np.asarray(out[N - 10:]).any()
    want_gx, want_gw = ref_spmm_grads(src, dst, w64, x64, reduce, ct,
                                      accum_dtype(dtype))
    assert norm_err(gx, want_gx) <= TOL[dtype]
    if len(src):
        assert norm_err(gw, want_gw) <= TOL[dtype]
        if case == "padded":        # pad edges are exact no-ops
            assert not np.asarray(gw[dst == N]).any()


@pytest.mark.parametrize("case", ["padded", "powerlaw"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_bspmm_grid(reduce, heads, dtype, case):
    """Multi-head SpMM == one single-head SpMM per head."""
    src, dst, w = graph(case, seed=heads)
    rng = np.random.default_rng(heads + 7)
    f = 8
    x = jnp.asarray(rng.normal(size=(N, heads, f)), dtype)
    a = rng.uniform(0.5, 1.5, (len(src), heads)).astype(np.float32)
    aj = jnp.asarray(a, dtype)
    ei = jnp.asarray(np.stack([src, dst]).astype(np.int32))
    out = bspmm(ei, aj, x, num_nodes=N, reduce=reduce)
    assert out.shape == (N, heads, f)
    x64 = np.asarray(x.astype(jnp.float32), np.float64)
    a64 = np.asarray(aj.astype(jnp.float32), np.float64)
    for h in range(heads):
        want = ref_spmm(src, dst, a64[:, h], x64[:, h], reduce,
                        accum_dtype(dtype))
        assert norm_err(out[:, h], want) <= TOL[dtype]
    g = jax.grad(lambda x: bspmm(ei, aj, x, num_nodes=N, reduce=reduce)
                 .astype(jnp.float32).sum())(x)
    assert np.isfinite(np.asarray(g, np.float32)).all()


def ref_softmax(scores, dst):
    s = np.asarray(scores, np.float64)
    out = np.zeros_like(s)
    for d in np.unique(dst[dst < N]):
        m = dst == d
        ex = np.exp(s[m] - s[m].max(0))
        out[m] = ex / ex.sum(0)
    return out


@pytest.mark.parametrize("case", ["padded", "isolated", "duplicates"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("heads", [1, 3])
def test_edge_softmax(heads, dtype, case):
    src, dst, _ = graph(case, seed=heads)
    rng = np.random.default_rng(3)
    s = jnp.asarray(rng.normal(size=(len(dst), heads)) * 3, dtype)
    alpha = segment_softmax(s, jnp.asarray(dst.astype(np.int32)), N)
    want = ref_softmax(np.asarray(s.astype(jnp.float32)), dst)
    valid = dst < N
    got = np.asarray(alpha.astype(jnp.float32))
    assert norm_err(got[valid], want[valid]) <= TOL[dtype]
    # each destination's weights sum to one per head
    sums = np.zeros((N, heads))
    np.add.at(sums, dst[valid], got[valid])
    hit = np.bincount(dst[valid], minlength=N) > 0
    np.testing.assert_allclose(sums[hit], 1.0,
                               atol=1e-5 if dtype == jnp.float32 else 3e-2)
    # all-masked (pad) rows carry no weight into any real destination
    if case == "padded":
        assert np.isfinite(got[~valid]).all()


@pytest.mark.parametrize("op", ["dot", "add", "mul", "sub"])
@pytest.mark.parametrize("heads", [1, 3])
def test_sddmm_ops(op, heads):
    src, dst, _ = graph("padded", seed=heads)
    rng = np.random.default_rng(5)
    a = rng.normal(size=(N, heads, 6)).astype(np.float32)
    b = rng.normal(size=(N, heads, 6)).astype(np.float32)
    ei = jnp.asarray(np.stack([src, dst]).astype(np.int32))
    got = np.asarray(sddmm(ei, jnp.asarray(a), jnp.asarray(b), op=op))
    bs = b[np.minimum(dst, N - 1)]          # pad dst gathers clamp
    want = {"dot": (a[src] * bs).sum(-1), "add": a[src] + bs,
            "mul": a[src] * bs, "sub": a[src] - bs}[op]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    g = jax.grad(lambda a: sddmm(ei, a, jnp.asarray(b), op=op).sum())(
        jnp.asarray(a))
    want_g = np.zeros_like(a)
    gb = bs if op in ("dot", "mul") else np.ones_like(bs)
    if op == "dot":
        np.add.at(want_g, src, bs)
    else:
        np.add.at(want_g, src, gb)
    np.testing.assert_allclose(np.asarray(g), want_g, rtol=1e-4, atol=1e-4)
