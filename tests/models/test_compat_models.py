"""Functional tests for the reference-name compat models/layers.

Each new (non-alias) class is run forward on a tiny graph and checked for
shape and finiteness; losses additionally for scalar-ness. Dense-math
cross-checks where the semantics allow (LogReg, amp ELBO).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gammagl_tpu.layers.conv import MAGCLConv, MGNNI_m_iter, GCNConv
from gammagl_tpu.models import (
    AGNNModel, FILMModel, GMMModel, DNAModel, HCHA, LogReg, SkipGramModel,
    MGNNI_m_att, DFADModel, DFADGenerator, Generator, Discriminator,
    EigenMLP, Encoder, SpaSpeNode, ReModel, EdgePromptNodeClassifier,
    GNN, amp_elbo_regression_loss, TADWModel)


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(0)
    n, e, f, c = 12, 40, 6, 3
    ei = jnp.asarray(np.stack([rng.integers(0, n, e),
                               rng.integers(0, n, e)]).astype(np.int32))
    x = jnp.asarray(rng.normal(size=(n, f)).astype(np.float32))
    y = jnp.asarray(rng.integers(0, c, n).astype(np.int32))
    return n, ei, x, y, c


def _run(model, *args, **kwargs):
    params = model.init(jax.random.PRNGKey(0), *args, **kwargs)
    out = model.apply(params, *args, **kwargs)
    return out


@pytest.mark.parametrize("cls", [AGNNModel, FILMModel, GMMModel, DNAModel,
                                 DFADModel, GNN])
def test_node_classifiers(tiny, cls):
    n, ei, x, _, c = tiny
    out = _run(cls(num_class=c, hidden_dim=8), x, ei)
    assert out.shape == (n, c)
    assert np.isfinite(np.asarray(out)).all()


def test_hcha(tiny):
    n, ei, x, _, c = tiny
    # incidence pairs (node, hyperedge)
    out = _run(HCHA(num_class=c, hidden_dim=8), x, ei, None, n, None)
    assert out.shape == (n, c)
    assert np.isfinite(np.asarray(out)).all()


def test_magcl_conv_k_matches_repeated_gcn_propagation(tiny):
    n, ei, x, _, _ = tiny
    conv = MAGCLConv(8, add_bias=False)
    params = conv.init(jax.random.PRNGKey(0), x, ei, k=1)
    out1 = conv.apply(params, x, ei, k=1)
    out3 = conv.apply(params, x, ei, k=3)
    assert out1.shape == out3.shape == (n, 8)
    # k=3 is three propagations of the k=1 linear output
    from gammagl_tpu.ops import spmm
    from gammagl_tpu.utils import calc_gcn_norm
    w = calc_gcn_norm(ei, n)
    ref = out1
    for _ in range(2):
        ref = spmm(ei, w.astype(ref.dtype), ref, num_nodes=n)
    np.testing.assert_allclose(np.asarray(out3), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def test_mgnni_iter_contracts(tiny):
    n, ei, x, _, _ = tiny
    layer = MGNNI_m_iter(m=x.shape[1], k=1, max_iter=30)
    params = layer.init(jax.random.PRNGKey(0), x, ei)
    z = layer.apply(params, x, ei)
    assert z.shape == x.shape
    # F initializes to zero -> g(F)=0 -> equilibrium is exactly x
    np.testing.assert_allclose(np.asarray(z), np.asarray(x), atol=1e-6)


def test_mgnni_att(tiny):
    n, ei, x, _, c = tiny
    out = _run(MGNNI_m_att(num_class=c, hidden_dim=8, iters=3), x, ei)
    assert out.shape == (n, c)
    assert np.isfinite(np.asarray(out)).all()


def test_logreg_linear():
    x = jnp.asarray(np.random.default_rng(1).normal(size=(5, 4)),
                    jnp.float32)
    m = LogReg(out_dim=3)
    p = m.init(jax.random.PRNGKey(0), x)
    out = m.apply(p, x)
    ref = x @ p["params"]["Dense_0"]["kernel"] + p["params"]["Dense_0"]["bias"]
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-6)


def test_skipgram_loss_positive_scalar():
    rng = np.random.default_rng(2)
    pos = jnp.asarray(rng.integers(0, 10, (6, 4)).astype(np.int32))
    neg = jnp.asarray(rng.integers(0, 10, (6, 4)).astype(np.int32))
    m = SkipGramModel(num_nodes=10, embedding_dim=8)
    loss = _run(m, pos, neg)
    assert loss.shape == () and float(loss) > 0


def test_graphgan_halves():
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.integers(0, 8, 16).astype(np.int32))
    v = jnp.asarray(rng.integers(0, 8, 16).astype(np.int32))
    lab = jnp.asarray(rng.integers(0, 2, 16).astype(np.float32))
    d = Discriminator(num_nodes=8, embedding_dim=4)
    pd = d.init(jax.random.PRNGKey(0), u, v, lab)
    d_loss = d.apply(pd, u, v, lab)
    reward = d.apply(pd, u, v, method=Discriminator.reward)
    g = Generator(num_nodes=8, embedding_dim=4)
    g_loss = _run(g, u, v, jax.lax.stop_gradient(reward))
    assert float(d_loss) > 0 and np.isfinite(float(g_loss))


def test_sp2gcl_components(tiny):
    n, ei, x, _, _ = tiny
    eigvecs = jnp.asarray(np.random.default_rng(4).normal(size=(n, 5)),
                          jnp.float32)
    eigvals = jnp.linspace(0.0, 2.0, 5)
    h_spa, h_spe = _run(SpaSpeNode(hidden_dim=8), x, ei, eigvecs, eigvals)
    assert h_spa.shape == (n, 8) and h_spe.shape == (n, 8)
    z = _run(Encoder(hidden_dim=8), x, ei)
    assert z.shape == (n, 8)
    e = _run(EigenMLP(hidden_dim=8), eigvecs, eigvals)
    assert e.shape == (n, 8)


def test_remodel_and_head():
    errs = jnp.asarray(np.random.default_rng(5).random((7, 3)),
                       jnp.float32)
    score = _run(ReModel(), errs)
    assert score.shape == (7,)
    h = jnp.asarray(np.random.default_rng(6).normal(size=(7, 8)),
                    jnp.float32)
    out = _run(EdgePromptNodeClassifier(num_class=3), h)
    assert out.shape == (7, 3)


def test_dfad_generator():
    z = jnp.asarray(np.random.default_rng(7).normal(size=(2, 16)),
                    jnp.float32)
    feats, adj = _run(DFADGenerator(num_nodes_out=6, feat_dim=5), z)
    assert feats.shape == (2, 6, 5) and adj.shape == (2, 6, 6)
    a = np.asarray(adj)
    assert (a >= 0).all() and (a <= 1).all()
    np.testing.assert_allclose(a, np.swapaxes(a, 1, 2), atol=1e-6)


def test_amp_elbo_matches_hand_calc():
    rng = np.random.default_rng(8)
    out_state = rng.normal(size=(4, 2, 1)).astype(np.float32)
    targets = rng.normal(size=(4,)).astype(np.float32)
    qL = np.asarray([[0.3, 0.7]], np.float32)
    loss = amp_elbo_regression_loss(
        out_state, targets, jnp.zeros((1, 2)), jnp.zeros((1, 2)),
        jnp.zeros((1, 2)), jnp.zeros(()), jnp.asarray(qL), 4.0)
    se = ((out_state[:, :, 0] - targets[:, None]) ** 2)
    log_p_y = -se.mean(0) / 2.0 * 4.0
    expect = -float((log_p_y * qL[0]).sum() / 4.0)
    np.testing.assert_allclose(float(loss), expect, rtol=1e-5)


def test_tadw_class():
    rng = np.random.default_rng(9)
    adj = (rng.random((10, 10)) < 0.3).astype(np.float32)
    text = rng.normal(size=(10, 6)).astype(np.float32)
    m = TADWModel(dim=4, iters=3)
    emb = m.fit(adj, text)
    assert emb.shape == (10, 8)
    assert np.isfinite(emb).all()
