"""REAL multi-process data-parallel training demo (jax.distributed).

Everything else in the repo tests multi-chip behavior on a single-process
virtual mesh; this script runs the full multi-HOST path: N separate
Python processes (gloo collectives on CPU), each host sampling its own
disjoint seed shard through `MultiHostNodeLoader`, assembling global
dp-sharded batches with `jax.make_array_from_process_local_data`, and
stepping a jit'd GCN whose gradient reduction crosses process boundaries.

    python scripts/run_multihost_demo.py                 # parent: spawn 2
    python scripts/run_multihost_demo.py --num-processes 4

On several GPU hosts the same worker code runs unchanged (drop the CPU
forcing; give jax.distributed.initialize() the coordinator address,
process count and process id).
"""

import argparse
import os
import os.path as osp
import subprocess
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)

DEVICES_PER_PROC = 4


def worker(pid, nproc, port, steps=12):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count="
                               + str(DEVICES_PER_PROC))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(f"localhost:{port}", num_processes=nproc,
                               process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from gammagl_tpu.datasets import synthetic_community_graph
    from gammagl_tpu.loader.multihost import MultiHostNodeLoader
    from gammagl_tpu.ops import segment_sum
    from gammagl_tpu.sampler import NeighborSampler

    # every host builds the SAME graph (same seed) — stands in for a
    # shared filesystem copy of the dataset
    g = synthetic_community_graph(600, 4, 16, avg_degree=8, seed=0)
    sampler = NeighborSampler(np.asarray(g.edge_index), g.num_nodes,
                              [5, 5], seed=0)
    mesh = Mesh(np.asarray(jax.devices()), ("dp",))
    loader = MultiHostNodeLoader(g, sampler, mesh, batch_size=64,
                                 shuffle=True, seed=0)

    rng = np.random.default_rng(0)  # same init on every host
    f, h, c = g.x.shape[1], 32, int(np.asarray(g.y).max()) + 1
    params = {
        "w1": jnp.asarray(rng.normal(size=(f, h)) * 0.1, jnp.float32),
        "w2": jnp.asarray(rng.normal(size=(h, c)) * 0.1, jnp.float32),
    }
    opt = optax.adam(5e-3)
    opt_state = opt.init(params)

    def block_forward(p, blk):
        x, ei = blk["x"], blk["edge_index"]
        w = blk["edge_mask"].astype(jnp.float32)
        n = x.shape[0]

        def layer(wmat, feat):
            msg = jnp.take(feat @ wmat, ei[0], axis=0,
                           mode="clip") * w[:, None]
            return segment_sum(msg, ei[1], n)

        h1 = jax.nn.relu(layer(p["w1"], x))
        return layer(p["w2"], h1)

    @jax.jit
    def train_step(p, opt_state, batch):
        def loss_fn(p):
            logits = jax.vmap(lambda blk: block_forward(p, blk))(batch)
            ls = optax.softmax_cross_entropy_with_integer_labels(
                logits, batch["y"].astype(jnp.int32))
            m = batch["seed_mask"].astype(jnp.float32)
            return (ls * m).sum() / jnp.maximum(m.sum(), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(p, updates), opt_state, loss

    losses = []
    done = 0
    while done < steps:
        for batch in loader:
            params, opt_state, loss = train_step(params, opt_state, batch)
            losses.append(float(loss))
            done += 1
            if done >= steps:
                break
    if pid == 0:
        print(f"[rank 0] {nproc} procs x {DEVICES_PER_PROC} devices: "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({done} steps)", flush=True)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses

    # halo exchange ACROSS processes: the papers100M-tier all_to_all must
    # ride the cross-host transport, not just intra-process virtual devs
    from gammagl_tpu.parallel.halo import (build_halo_partition,
                                           make_halo_spmm)
    n = g.num_nodes
    ei = np.asarray(g.edge_index)
    wgt = np.abs(rng.normal(size=ei.shape[1])).astype(np.float32)
    ndev = jax.device_count()
    # balance=False: this check compares shard rows positionally against
    # the natural-order dense reference (the transport is what's tested)
    part = build_halo_partition(ei, n, ndev, wgt, balance=False)
    total = ndev * part.rows_per
    x_full = rng.normal(size=(total, 8)).astype(np.float32)  # same seed
    x_full[n:] = 0
    rows_per_host = total // nproc
    local = x_full[pid * rows_per_host:(pid + 1) * rows_per_host]
    xs = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("dp")), local)
    out = jax.jit(make_halo_spmm(mesh, part))(xs)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (ei[1], ei[0]), wgt)
    want = dense @ x_full[:n]
    for sh in out.addressable_shards:
        lo = sh.index[0].start or 0
        got = np.asarray(sh.data)
        ref = np.zeros_like(got)
        valid = max(0, min(n - lo, got.shape[0]))
        if valid > 0:
            ref[:valid] = want[lo:lo + valid]
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    # full-graph PARTITIONED TRAINING tier across processes: the halo
    # all_to_all + segment-sum aggregation + gradient
    # psum all cross the process boundary, with loss/parameter parity
    # against a single-device reference computed locally (every rank
    # holds the same seeded graph, so the reference is deterministic).
    import time as _time
    from gammagl_tpu.parallel import make_partitioned_gcn_train
    from gammagl_tpu.utils import calc_gcn_norm_np

    ei_sl = np.concatenate(
        [ei, np.tile(np.arange(n, dtype=np.int64), (2, 1))], axis=1)
    w_norm = calc_gcn_norm_np(ei_sl, n)
    part_t = build_halo_partition(ei_sl, n, ndev, w_norm, balance=False)
    total = ndev * part_t.rows_per
    f2, h2, c2 = g.x.shape[1], 16, int(np.asarray(g.y).max()) + 1
    x_pad = np.zeros((total, f2), np.float32)
    x_pad[:n] = np.asarray(g.x)
    y_pad = np.zeros((total,), np.int64)
    y_pad[:n] = np.asarray(g.y)
    m_pad = np.zeros((total,), np.float32)
    m_pad[:n] = 1.0
    rows_per_host = total // nproc
    sl = slice(pid * rows_per_host, (pid + 1) * rows_per_host)
    sh = NamedSharding(mesh, P("dp"))
    xs2 = jax.make_array_from_process_local_data(sh, x_pad[sl])
    ys2 = jax.make_array_from_process_local_data(sh, y_pad[sl])
    ms2 = jax.make_array_from_process_local_data(sh, m_pad[sl])
    params, opt_state, pstep, _ = make_partitioned_gcn_train(
        mesh, part_t, f2, h2, c2, num_layers=2,
        compute_dtype=jnp.float32, learning_rate=1e-2, seed=7)

    # single-device reference: identical math on the full graph
    import optax as _optax
    from gammagl_tpu.ops import spmm as _spmm
    p_ref = jax.tree_util.tree_map(np.asarray, params)
    p_ref = {k: jnp.asarray(v) for k, v in p_ref.items()}
    opt_ref = _optax.adamw(1e-2, weight_decay=0.0)
    st_ref = opt_ref.init(p_ref)
    ei_j = jnp.asarray(ei_sl.astype(np.int32))
    w_j = jnp.asarray(w_norm.astype(np.float32))
    xf = jnp.asarray(x_pad[:n])
    yf = jnp.asarray(y_pad[:n])
    mf = jnp.asarray(m_pad[:n])

    @jax.jit
    def ref_step(p, st):
        def loss_fn(p):
            h = _spmm(ei_j, w_j, xf, num_nodes=n) @ p["w0"] + p["b0"]
            h = jax.nn.relu(h)
            lg = _spmm(ei_j, w_j, h, num_nodes=n) @ p["w1"] + p["b1"]
            ls = _optax.softmax_cross_entropy_with_integer_labels(lg, yf)
            return (ls * mf).sum() / mf.sum()
        loss, grads = jax.value_and_grad(loss_fn)(p)
        up, st = opt_ref.update(grads, st, p)
        return _optax.apply_updates(p, up), st, loss

    losses_p, losses_r = [], []
    t0 = _time.perf_counter()
    for _ in range(5):
        params, opt_state, lp = pstep(params, opt_state, xs2, ys2, ms2)
        p_ref, st_ref, lr_ = ref_step(p_ref, st_ref)
        losses_p.append(float(lp))
        losses_r.append(float(lr_))
    dt = (_time.perf_counter() - t0) / 5
    np.testing.assert_allclose(losses_p, losses_r, rtol=2e-4, atol=2e-4)
    for k in p_ref:
        np.testing.assert_allclose(
            np.asarray(params[k]), np.asarray(p_ref[k]),
            rtol=2e-3, atol=2e-3)
    eps = ei_sl.shape[1] / dt / nproc
    print(f"[rank {pid}] partitioned-tier parity OK "
          f"(loss {losses_p[0]:.4f}->{losses_p[-1]:.4f}, "
          f"{eps:.2e} edges/s/process)", flush=True)
    print(f"[rank {pid}] OK (train + cross-process halo exchange)",
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--port", type=int, default=12411)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--process-id", type=int, default=None,
                    help="(internal) run as worker")
    args = ap.parse_args()
    if args.process_id is not None:
        worker(args.process_id, args.num_processes, args.port, args.steps)
        return
    procs = [subprocess.Popen(
        [sys.executable, osp.abspath(__file__),
         "--process-id", str(i),
         "--num-processes", str(args.num_processes),
         "--port", str(args.port), "--steps", str(args.steps)])
        for i in range(args.num_processes)]
    rcs = [p.wait(timeout=600) for p in procs]
    assert all(rc == 0 for rc in rcs), rcs
    print("MULTIHOST DEMO OK")


if __name__ == "__main__":
    main()
