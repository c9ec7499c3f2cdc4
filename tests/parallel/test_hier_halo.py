"""Two-level (slice x dp) halo SpMM vs single-device reference on a
2x4 virtual mesh, plus gradient parity, inter-host dedup accounting, and the
full-graph GCN recipe running on the hierarchical partition."""

import numpy as np
import jax
import jax.numpy as jnp

from gammagl_tpu.ops import spmm
from gammagl_tpu.parallel import (build_halo_partition, make_mesh,
                                  pad_nodes, unpad_nodes, shard_nodes,
                                  make_partitioned_gcn_train,
                                  sign_precompute)
from gammagl_tpu.parallel.hier_halo import (build_hier_halo_partition,
                                            make_hier_halo_spmm,
                                            traffic_report)
from jax.sharding import NamedSharding, PartitionSpec as P


def _case(seed=0, n=100, e=600, f=16):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    return ei, w, x


def _mesh2d():
    return make_mesh(shape=(2, 4), axis_names=("slice", "dp"))


def test_hier_halo_spmm_matches_dense():
    ei, w, x = _case()
    n = 100
    mesh = _mesh2d()
    part = build_hier_halo_partition(ei, n, 2, 4, w)
    fn = make_hier_halo_spmm(mesh, part)
    xp = shard_nodes(x, mesh, part)
    out = fn(xp)
    ref = spmm(jnp.asarray(ei), jnp.asarray(w), jnp.asarray(x), num_nodes=n)
    np.testing.assert_allclose(np.asarray(out)[:n], np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out)[n:], 0.0)


def test_hier_halo_spmm_grad():
    ei, w, x = _case(seed=1, n=64, e=300, f=8)
    mesh = _mesh2d()
    part = build_hier_halo_partition(ei, 64, 2, 4, w)
    fn = make_hier_halo_spmm(mesh, part)
    xp = jnp.asarray(pad_nodes(x, part))
    g_halo = jax.grad(lambda x: (fn(x) ** 2).sum())(xp)
    g_ref = jax.grad(lambda x: (spmm(jnp.asarray(ei), jnp.asarray(w), x,
                                     num_nodes=64) ** 2).sum())(
        jnp.asarray(x))
    np.testing.assert_allclose(unpad_nodes(g_halo, part),
                               np.asarray(g_ref), rtol=1e-4, atol=1e-4)


def test_hier_matches_flat_partition_traffic():
    """Host dedup never moves MORE rows across hosts than the flat scheme,
    and on a graph with shared remote neighbors it moves strictly fewer."""
    # hub graph: node 0 (slice 0) feeds every node of slice 1
    n = 64
    dst = np.arange(n // 2, n)
    ei = np.stack([np.zeros_like(dst), dst])
    part = build_hier_halo_partition(ei, n, 2, 4)
    rep = traffic_report(part, feat_dim=128)
    assert rep["inter_host_bytes"] <= rep["inter_host_bytes_flat"]
    # row 0 crosses hosts once (deduped) instead of once per consumer device
    assert rep["dedup_factor"] == 4.0


def test_hier_partitioned_gcn_trains():
    ei, w, x = _case(seed=2, n=80, e=500, f=12)
    n, c = 80, 3
    y = np.random.default_rng(0).integers(0, c, n)
    mesh = _mesh2d()
    part = build_hier_halo_partition(ei, n, 2, 4, np.abs(w))
    total = part.num_parts * part.rows_per
    params, opt_state, step, eval_logits = make_partitioned_gcn_train(
        mesh, part, feat_dim=12, hidden_dim=16, num_classes=c,
        compute_dtype=jnp.float32, axis=("slice", "dp"))
    xp = shard_nodes(x, mesh, part, axis=("slice", "dp"))
    yp = shard_nodes(y, mesh, part, axis=("slice", "dp"))
    mask = shard_nodes((np.arange(n) < n).astype(np.float32), mesh, part,
                       axis=("slice", "dp"))
    losses = []
    for _ in range(12):
        params, opt_state, loss = step(params, opt_state, xp, yp, mask)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert eval_logits(params, xp).shape == (total, c)


def test_hier_sign_precompute_matches_single_level():
    ei, w, x = _case(seed=3, n=72, e=400, f=8)
    mesh2 = _mesh2d()
    part2 = build_hier_halo_partition(ei, 72, 2, 4, w)
    ops2 = sign_precompute(mesh2, part2,
                           shard_nodes(x, mesh2, part2), num_hops=2,
                           store_dtype=jnp.float32)
    mesh1 = make_mesh(axis_names=("dp",))
    part1 = build_halo_partition(ei, 72, 8, w)
    ops1 = sign_precompute(mesh1, part1,
                           shard_nodes(x, mesh1, part1), num_hops=2,
                           store_dtype=jnp.float32)
    for a, b in zip(ops1, ops2):
        np.testing.assert_allclose(np.asarray(a)[:72], np.asarray(b)[:72],
                                   rtol=1e-4, atol=1e-4)
