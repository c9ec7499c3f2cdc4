"""Memory-budgeted full-graph recipes (papers100M tier) on the 8-device
virtual mesh: SIGN precompute vs dense powers, partitioned L-layer GCN
training (remat + bf16 activations) learns a separable synthetic task."""

import numpy as np
import jax
import jax.numpy as jnp

from gammagl_tpu.parallel import (build_halo_partition, make_mesh,
                                  make_partitioned_gcn_train, pad_nodes,
                                  shard_nodes, sign_precompute,
                                  estimate_hbm_gb)
from gammagl_tpu.utils import calc_gcn_norm


def _sbm(seed=0, n=96, f=12, p_in=0.20, p_out=0.01):
    """Two-community SBM with community-informative features."""
    rng = np.random.default_rng(seed)
    y = (np.arange(n) >= n // 2).astype(np.int32)
    prob = np.where(y[:, None] == y[None, :], p_in, p_out)
    adj = rng.random((n, n)) < prob
    np.fill_diagonal(adj, True)
    src, dst = np.nonzero(adj)
    ei = np.stack([src, dst]).astype(np.int64)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[:, 0] += (2 * y - 1) * 0.8
    return ei, x, y


def test_sign_precompute_matches_dense_powers():
    ei, x, _ = _sbm()
    n = x.shape[0]
    w = np.asarray(calc_gcn_norm(jnp.asarray(ei), n))
    mesh = make_mesh(axis_names=("dp",))
    part = build_halo_partition(ei, n, 8, w)
    xs = shard_nodes(x, mesh, part)
    ops = sign_precompute(mesh, part, xs, num_hops=2,
                          store_dtype=jnp.float32)

    a = np.zeros((n, n), np.float32)
    np.add.at(a, (ei[1], ei[0]), w)  # out[d] += w * x[s]
    want = [x, a @ x, a @ (a @ x)]
    for got, ref in zip(ops, want):
        np.testing.assert_allclose(np.asarray(got)[:n], ref,
                                   rtol=1e-4, atol=1e-4)


def test_partitioned_gcn_trains_bf16_remat():
    ei, x, y = _sbm()
    n, f = x.shape
    w = np.asarray(calc_gcn_norm(jnp.asarray(ei), n))
    mesh = make_mesh(axis_names=("dp",))
    part = build_halo_partition(ei, n, 8, w)

    params, opt_state, step, eval_logits = make_partitioned_gcn_train(
        mesh, part, feat_dim=f, hidden_dim=16, num_classes=2,
        num_layers=3, compute_dtype=jnp.bfloat16, remat=True,
        learning_rate=5e-2)

    mask = np.zeros(n, np.float32)
    mask[np.random.default_rng(1).choice(n, n // 2, replace=False)] = 1.0
    xs = shard_nodes(x, mesh, part)
    ys = shard_nodes(y, mesh, part)
    ms = shard_nodes(mask, mesh, part)

    losses = []
    for _ in range(60):
        params, opt_state, loss = step(params, opt_state, xs, ys, ms)
        losses.append(float(loss))
    assert losses[-1] < 0.4 * losses[0], losses[::10]

    logits = np.asarray(eval_logits(params, xs))[:n]
    test = mask == 0
    acc = (logits.argmax(1)[test] == y[test]).mean()
    assert acc > 0.85, acc


def test_partitioned_gcn_remat_matches_norem():
    """remat must be numerically exact (same step, same loss)."""
    ei, x, y = _sbm(seed=3, n=64, f=8)
    n, f = x.shape
    w = np.asarray(calc_gcn_norm(jnp.asarray(ei), n))
    mesh = make_mesh(axis_names=("dp",))
    part = build_halo_partition(ei, n, 8, w)
    mask = np.ones(n, np.float32)
    xs = shard_nodes(x, mesh, part)
    ys = shard_nodes(y, mesh, part)
    ms = shard_nodes(mask, mesh, part)

    out = {}
    for remat in (False, True):
        p, s, step, _ = make_partitioned_gcn_train(
            mesh, part, f, 16, 2, num_layers=2,
            compute_dtype=jnp.float32, remat=remat, seed=7)
        for _ in range(3):
            p, s, loss = step(p, s, xs, ys, ms)
        out[remat] = (float(loss),
                      np.asarray(jax.tree_util.tree_leaves(p)[0]))
    assert out[False][0] == out[True][0]
    np.testing.assert_array_equal(out[False][1], out[True][1])


def test_estimate_hbm_budget_sanity():
    # papers100M-shaped: 111M nodes, 128 feats, deg ~13, 16 chips
    gb_bf16 = estimate_hbm_gb(111_059_956, 128, 256, 3, 16, 13,
                              compute_dtype=jnp.bfloat16, remat=True)
    gb_f32 = estimate_hbm_gb(111_059_956, 128, 256, 3, 16, 13,
                             compute_dtype=jnp.float32, remat=False)
    assert gb_bf16 < gb_f32
    assert 0.5 < gb_bf16 < 16.0
