"""Attention convs (GAT, GATv2, HGT relation attention, FusedGAT) against
float64 numpy forms of their formulas, forward and gradient."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gammagl_tpu.layers.conv import (FusedGATConv, GATConv, GATV2Conv,
                                     HGTConv)
from gammagl_tpu.layers.conv.hetero_conv import relation_attention
from gammagl_tpu.models import FusedGATModel

N, E = 30, 150


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, N, E), rng.integers(0, N - 5, E)])
    x = rng.normal(size=(N, 6)).astype(np.float32)
    return ei.astype(np.int32), x


def _softmax_by_dst(e, dst):
    out = np.zeros_like(e)
    for d in np.unique(dst):
        m = dst == d
        ex = np.exp(e[m] - e[m].max(0))
        out[m] = ex / ex.sum(0)
    return out


def _aggregate(alpha, msg, dst):
    out = np.zeros((N,) + msg.shape[1:])
    np.add.at(out, dst, alpha[..., None] * msg)
    return out


def _leaky(v, slope=0.2):
    return np.where(v > 0, v, slope * v)


def ref_gat(p, x, ei, heads, f, concat):
    src, dst = ei
    h = (x.astype(np.float64) @ p["w"]).reshape(N, heads, f)
    att = np.asarray(p["att"], np.float64)[0]
    e = _leaky((h[src] * att[:, :f]).sum(-1) + (h[dst] * att[:, f:]).sum(-1))
    out = _aggregate(_softmax_by_dst(e, dst), h[src], dst)
    out = out.reshape(N, heads * f) if concat else out.mean(1)
    return out + p["bias"]


def ref_gatv2(p, x, ei, heads, f):
    src, dst = ei
    xl = (x.astype(np.float64) @ p["Dense_0"]["kernel"]).reshape(N, heads, f)
    xr = (x.astype(np.float64) @ p["Dense_1"]["kernel"]).reshape(N, heads, f)
    e = (_leaky(xl[src] + xr[dst]) * np.asarray(p["att"])[0]).sum(-1)
    out = _aggregate(_softmax_by_dst(e, dst), xl[src], dst)
    return out.reshape(N, heads * f) + p["bias"]


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("heads", [1, 3])
def test_gat_conv_matches_formula(heads, concat):
    ei, x = _graph(heads)
    conv = GATConv(4, heads=heads, concat=concat)
    p = conv.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ei))
    out = conv.apply(p, jnp.asarray(x), jnp.asarray(ei))
    want = ref_gat(_np(p["params"]), x, ei, heads, 4, concat)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-5)
    # isolated destinations (no incoming edge) get the bias only
    np.testing.assert_allclose(np.asarray(out)[N - 5:],
                               np.broadcast_to(np.asarray(
                                   p["params"]["bias"]), (5, out.shape[1])),
                               atol=1e-6)


@pytest.mark.parametrize("heads", [1, 2])
def test_gatv2_conv_matches_formula(heads):
    ei, x = _graph(10 + heads)
    conv = GATV2Conv(4, heads=heads)
    p = conv.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(ei))
    out = conv.apply(p, jnp.asarray(x), jnp.asarray(ei))
    want = ref_gatv2(_np(p["params"]), x, ei, heads, 4)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-5)


def test_gat_conv_grad_matches_finite_difference():
    ei, x = _graph(4)
    conv = GATConv(3, heads=2)
    p = conv.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(ei))
    ct = np.random.default_rng(0).normal(size=(N, 6))

    def loss(att):
        q = dict(p["params"], att=att)
        return (conv.apply({"params": q}, jnp.asarray(x), jnp.asarray(ei))
                * ct).sum()

    att = p["params"]["att"]
    g = np.asarray(jax.grad(loss)(att))

    def ref_loss(att):
        return (ref_gat(dict(_np(p["params"]), att=att), x, ei, 2, 3, True)
                * ct).sum()

    a64 = np.asarray(att, np.float64)
    eps = 1e-6
    fd = np.zeros_like(a64)
    for idx in np.ndindex(a64.shape):
        d = np.zeros_like(a64)
        d[idx] = eps
        fd[idx] = (ref_loss(a64 + d) - ref_loss(a64 - d)) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("heads", [1, 4])
def test_relation_attention_matches_formula(heads):
    rng = np.random.default_rng(heads)
    n_src, n_dst, d = 25, 12, 8
    ei = np.stack([rng.integers(0, n_src, 90),
                   rng.integers(0, n_dst - 2, 90)]).astype(np.int32)
    q = rng.normal(size=(n_dst, heads, d)).astype(np.float32)
    k = rng.normal(size=(n_src, heads, d)).astype(np.float32)
    v = rng.normal(size=(n_src, heads, d)).astype(np.float32)
    pri = rng.uniform(0.5, 2.0, heads).astype(np.float32)
    out = relation_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(ei), n_dst, jnp.asarray(pri))
    src, dst = ei
    s = (q[dst].astype(np.float64) * k[src]).sum(-1) * pri / np.sqrt(d)
    alpha = _softmax_by_dst(s, dst)
    want = np.zeros((n_dst, heads, d))
    np.add.at(want, dst, alpha[..., None] * v[src])
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-5)
    assert not np.asarray(out)[n_dst - 2:].any()


def test_hgt_conv_trains_through_relation_attention():
    rng = np.random.default_rng(0)
    x = {"a": jnp.asarray(rng.normal(size=(20, 8)), jnp.float32),
         "b": jnp.asarray(rng.normal(size=(15, 8)), jnp.float32)}
    eis = {("a", "to", "b"): jnp.asarray(np.stack([
        rng.integers(0, 20, 60), rng.integers(0, 15, 60)]), jnp.int32),
        ("b", "to", "a"): jnp.asarray(np.stack([
            rng.integers(0, 15, 50), rng.integers(0, 20, 50)]), jnp.int32)}
    conv = HGTConv(8, (["a", "b"], list(eis)), heads=2, dropout_rate=0.0)
    p = conv.init(jax.random.PRNGKey(0), x, eis)
    assert "a_rel__a__to__b" in p["params"]
    out = conv.apply(p, x, eis)
    assert out["a"].shape == (20, 8) and out["b"].shape == (15, 8)
    g = jax.grad(lambda p: sum(o.sum() for o in conv.apply(
        p, x, eis).values()))(p)
    leaves = jax.tree_util.tree_leaves(g)
    assert all(np.isfinite(np.asarray(a)).all() for a in leaves)
    assert any(np.abs(np.asarray(a)).sum() > 0 for a in leaves)


def test_fused_gat_to_graph_format_sorts_by_destination():
    ei, _ = _graph(7)
    fmt = FusedGATConv.to_graph_format(ei, N)
    assert fmt.dtype == np.int32 and fmt.shape == ei.shape
    assert (np.diff(fmt[1]) >= 0).all()
    # same multiset of edges
    assert sorted(map(tuple, fmt.T)) == sorted(map(tuple, ei.T))


def test_fused_gat_matches_gat_on_sorted_edges():
    ei, x = _graph(8)
    fmt = jnp.asarray(FusedGATConv.to_graph_format(ei, N))
    conv, fused = GATConv(4, heads=2), FusedGATConv(4, heads=2)
    p = conv.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(ei))
    np.testing.assert_allclose(
        np.asarray(fused.apply(p, jnp.asarray(x), fmt)),
        np.asarray(conv.apply(p, jnp.asarray(x), jnp.asarray(ei))),
        rtol=1e-5, atol=1e-6)
    model = FusedGATModel(hidden_dim=4, num_class=3, heads=2, drop_rate=0.0)
    mp = model.init(jax.random.PRNGKey(4), jnp.asarray(x), fmt)
    out = model.apply(mp, jnp.asarray(x), fmt)
    assert out.shape == (N, 3) and np.isfinite(np.asarray(out)).all()
