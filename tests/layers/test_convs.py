"""Per-conv unit tests: tiny graph, shape + dense-equivalence checks.

Mirrors the reference style (tests/layers/conv/test_gcn_conv.py:14-38 checks
AXWb equivalence on a 4-node graph).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gammagl_tpu.layers.conv import (
    GCNConv, GATConv, GATV2Conv, SAGEConv, SGConv, GINConv, APPNPConv,
    GCNIIConv, ChebConv, AGNNConv, FAGCNConv, GPRConv, MixHopConv,
    JumpingKnowledge)
from gammagl_tpu.utils import add_self_loops


@pytest.fixture
def tiny():
    # 4-node graph (with self loops for GCN-style convs)
    ei = np.array([[0, 1, 2, 3, 0, 1], [1, 0, 1, 2, 2, 3]])
    ei, _ = add_self_loops(ei, num_nodes=4)
    x = np.arange(16, dtype=np.float32).reshape(4, 4) / 10.0
    return jnp.asarray(x), jnp.asarray(ei)


def _init_run(conv, *args, **kwargs):
    key = jax.random.PRNGKey(0)
    params = conv.init(key, *args, **kwargs)
    return conv.apply(params, *args, **kwargs), params


def test_gcn_conv_matches_dense(tiny):
    x, ei = tiny
    conv = GCNConv(out_channels=3, norm="both", add_bias=True)
    out, params = _init_run(conv, x, ei)
    assert out.shape == (4, 3)
    # dense check: out = D^-1/2 A D^-1/2 X W + b
    n = 4
    a = np.zeros((n, n), np.float32)
    ei_np = np.asarray(ei)
    a[ei_np[1], ei_np[0]] = 1.0
    # 'both' norm: weights = out_deg[src]^-1/2 * in_deg[dst]^-1/2
    # (reference gcn_conv.py:90-104 computes the left factor from src degree)
    dinv_in = np.diag(a.sum(1) ** -0.5)
    dinv_out = np.diag(a.sum(0) ** -0.5)
    w = np.asarray(params["params"]["Dense_0"]["kernel"])
    b = np.asarray(params["params"]["bias"])
    expect = dinv_in @ a @ dinv_out @ np.asarray(x) @ w + b
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("norm", ["left", "right", "none"])
def test_gcn_conv_norm_modes(tiny, norm):
    x, ei = tiny
    out, _ = _init_run(GCNConv(out_channels=3, norm=norm), x, ei)
    assert out.shape == (4, 3)
    assert np.isfinite(np.asarray(out)).all()


def test_gat_conv_shapes(tiny):
    x, ei = tiny
    out, _ = _init_run(GATConv(out_channels=5, heads=3), x, ei)
    assert out.shape == (4, 15)
    out, _ = _init_run(GATConv(out_channels=5, heads=3, concat=False), x, ei)
    assert out.shape == (4, 5)


def test_gat_attention_sums_to_one(tiny):
    """Attention rows must be a convex combination: constant features in ->
    constant aggregate out per head."""
    x, ei = tiny
    x1 = jnp.ones_like(x)
    conv = GATConv(out_channels=4, heads=2, add_bias=False)
    key = jax.random.PRNGKey(1)
    params = conv.init(key, x1, ei)
    out = conv.apply(params, x1, ei)
    w = np.asarray(params["params"]["w"])
    expect = np.tile(np.ones((1, 4), np.float32) @ w.reshape(4, -1), (4, 1))
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-4, atol=1e-5)


def test_gatv2_conv(tiny):
    x, ei = tiny
    out, _ = _init_run(GATV2Conv(out_channels=5, heads=2), x, ei)
    assert out.shape == (4, 10)


@pytest.mark.parametrize("aggr", ["mean", "gcn", "pool"])
def test_sage_conv(tiny, aggr):
    x, ei = tiny
    out, _ = _init_run(SAGEConv(out_channels=6, aggr=aggr), x, ei)
    assert out.shape == (4, 6)
    assert np.isfinite(np.asarray(out)).all()


def test_sage_bipartite(tiny):
    x, ei = tiny
    x_dst = x[:2]
    ei_b = jnp.asarray(np.array([[0, 1, 2, 3], [0, 0, 1, 1]]))
    out, _ = _init_run(SAGEConv(out_channels=6), (x, x_dst), ei_b)
    assert out.shape == (2, 6)


def test_sgc_conv(tiny):
    x, ei = tiny
    out, _ = _init_run(SGConv(out_channels=3, itera_k=2), x, ei)
    assert out.shape == (4, 3)


def test_gin_conv(tiny):
    x, ei = tiny
    out, _ = _init_run(GINConv(learn_eps=True), x, ei)
    assert out.shape == x.shape
    # eps=0, no apply_func: out = x + sum_neighbors
    from gammagl_tpu.ops import spmm
    expect = np.asarray(x) + np.asarray(spmm(ei, None, x))
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-5)


def test_appnp_conv(tiny):
    x, ei = tiny
    out, _ = _init_run(APPNPConv(itera_k=3, alpha=0.2), x, ei)
    assert out.shape == x.shape


def test_gcnii_conv(tiny):
    x, ei = tiny
    conv = GCNIIConv(out_channels=4, beta=0.3, alpha=0.2)
    key = jax.random.PRNGKey(0)
    params = conv.init(key, x, x, ei)
    out = conv.apply(params, x, x, ei)
    assert out.shape == (4, 4)


def test_cheb_conv(tiny):
    x, ei = tiny
    out, _ = _init_run(ChebConv(out_channels=3, K=3), x, ei)
    assert out.shape == (4, 3)
    assert np.isfinite(np.asarray(out)).all()


def test_agnn_conv(tiny):
    x, ei = tiny
    out, _ = _init_run(AGNNConv(), x, ei)
    assert out.shape == x.shape


def test_fagcn_conv(tiny):
    x, ei = tiny
    out, _ = _init_run(FAGCNConv(hidden_dim=4), x, ei)
    assert out.shape == x.shape


def test_gpr_conv(tiny):
    x, ei = tiny
    out, _ = _init_run(GPRConv(K=4, alpha=0.1), x, ei)
    assert out.shape == x.shape


def test_mixhop_conv(tiny):
    x, ei = tiny
    out, _ = _init_run(MixHopConv(out_channels=3, p=(0, 1, 2)), x, ei)
    assert out.shape == (4, 9)


def test_jumping_knowledge(tiny):
    x, _ = tiny
    xs = [x, x * 2, x * 3]
    out, _ = _init_run(JumpingKnowledge(mode="cat"), xs)
    assert out.shape == (4, 12)
    out, _ = _init_run(JumpingKnowledge(mode="max"), xs)
    np.testing.assert_allclose(np.asarray(out), np.asarray(x) * 3)
    out, _ = _init_run(JumpingKnowledge(mode="att"), xs)
    assert out.shape == (4, 4)
