"""ogbn-papers100M-scale partitioned full-graph training (GCN or SIGN).

This is the BASELINE.json papers100M config: nodes stay sharded over the
mesh for the whole run; the only cross-chip traffic is the per-layer halo
exchange (`gammagl_tpu.parallel.make_halo_spmm`, one all_to_all between
devices). The reference has NO counterpart — its biggest-graph story is
host-side neighbor sampling (SURVEY.md §2.10).

Recipes:
  --recipe gcn   L-layer GCN, bf16 activations, per-layer remat
                 (`make_partitioned_gcn_train`).
  --recipe sign  K halo-SpMM sweeps precompute [X, AX, ..., A^K X] once
                 (bf16 shards), then train a graph-free MLP on the
                 concatenated operands — the single-pass recipe when the
                 edge list dwarfs HBM.

Real data: point --features/--edges-file at the OGB npy/memmap dumps
(node_feat.npy float16 (111M, 128), edge_index.npy int64 (2, 1.6B)); the
partition builder streams per-part edge masks with numpy. Without files
the script scales a synthetic power-law graph by --scale so the full path
(partition -> shard -> train -> eval) always runs, e.g. on the CPU mesh:

  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  JAX_PLATFORMS=cpu python examples/papers100m/papers100m_trainer.py \
      --recipe sign --scale 0.001

Memory planning: `estimate_hbm_gb` (printed at startup) sizes the config
per chip before anything is allocated.
"""

import argparse
import os.path as osp
import sys
import time

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", ".."))

import numpy as np


def synthetic_papers(scale, seed=0, homophily=0.7):
    """Power-law-ish homophilous citation graph at `scale` x papers100M
    size (citation graphs cite within-field ~70% of the time; without
    homophily GCN aggregation would have no signal to learn)."""
    n = max(int(111_059_956 * scale), 256)
    e = max(int(1_615_685_872 * scale), 4 * n)
    f, c = 128, 172
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n).astype(np.int32)
    dst = rng.integers(0, n, e)
    # src: same class as dst w.p. homophily, else zipf-clamped anywhere
    order = np.argsort(y, kind="stable")
    counts = np.bincount(y, minlength=c)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    same = order[starts[y[dst]]
                 + (rng.random(e) * counts[y[dst]]).astype(np.int64)]
    anywhere = (rng.zipf(1.35, e).astype(np.int64) - 1) % n
    src = np.where(rng.random(e) < homophily, same, anywhere)
    ei = np.stack([src, dst])
    # features carry the label direction so training has signal
    x = rng.normal(size=(n, f)).astype(np.float32) * 0.5
    proto = rng.normal(size=(c, f)).astype(np.float32)
    x += proto[y]
    train = rng.random(n) < 0.01
    val = ~train & (rng.random(n) < 0.005)
    return ei, x, y, train, val, c


def load_ogb_root(root, name="ogbn-papers100M"):
    """Standard staged OGB directory (gammagl_tpu.datasets.OgbNodeDataset:
    raw/{node_feat,edge_index,node_label}.npy or data.npz + split/time/).
    Features stay memory-mapped until sharded to devices."""
    from gammagl_tpu.datasets import OgbNodeDataset
    g = OgbNodeDataset(root, name)[0]
    y = np.asarray(g.y).astype(np.int32) if "y" in g else np.zeros(
        g.num_nodes, np.int32)
    train = (np.asarray(g.train_mask) if "train_mask" in g
             else np.zeros(g.num_nodes, bool))
    val = (np.asarray(g.val_mask) if "val_mask" in g
           else np.zeros(g.num_nodes, bool))
    return (g.edge_index, g.x, y, train, val,
            max(int(y.max()) + 1, 2))


def load_real(args):
    x = np.load(args.features, mmap_mode="r")
    ei = np.load(args.edges_file, mmap_mode="r")
    # OGB dumps labels as (N, 1) float with NaN on unlabeled rows
    y = np.asarray(np.load(args.labels, mmap_mode="r")).reshape(-1)
    y = np.nan_to_num(y, nan=-1.0).astype(np.int32)
    train = np.load(args.train_idx)
    mask = np.zeros(x.shape[0], bool)
    mask[train] = True
    val = np.zeros(x.shape[0], bool)
    if args.val_idx:
        val[np.load(args.val_idx)] = True
    return ei, x, y, mask, val, int(y.max()) + 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--recipe", choices=["gcn", "sign"], default="gcn")
    ap.add_argument("--scale", type=float, default=0.0005,
                    help="synthetic fraction of papers100M")
    ap.add_argument("--data-root", default=None,
                    help="staged OGB directory root (contains "
                         "ogbn_papers100M/raw + split; see "
                         "gammagl_tpu/datasets/ogb.py). Takes "
                         "precedence over --features/--edges-file")
    ap.add_argument("--ogb-name", default="ogbn-papers100M")
    ap.add_argument("--features", default=None)
    ap.add_argument("--edges-file", default=None)
    ap.add_argument("--labels", default=None)
    ap.add_argument("--train-idx", default=None)
    ap.add_argument("--val-idx", default=None)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--hops", type=int, default=3, help="SIGN sweeps")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--f32", action="store_true",
                    help="f32 activations (default bf16)")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--rcm", action="store_true",
                    help="RCM reorder to shrink halos")
    ap.add_argument("--no-balance", action="store_true",
                    help="disable the default degree-balanced owner "
                         "blocks (parallel.balance_permutation). The "
                         "balanced relabeling is applied INSIDE the "
                         "partition builders by default — it equalizes "
                         "edges/device on power-law graphs (2x padded-"
                         "edge inflation at arxiv scale without it, "
                         "50% vs 100% overlapped scaling efficiency)")
    ap.add_argument("--slices", type=int, default=1,
                    help=">1: two-level halo over a (slices, dp) mesh — "
                         "all_to_all within a host, host-deduped "
                         "all_to_all across hosts (parallel/hier_halo.py)")
    ap.add_argument("--ckpt", default=None,
                    help="directory for orbax sharded checkpoints: "
                         "resume from it if present, save periodically")
    ap.add_argument("--ckpt-every", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import optax
    from gammagl_tpu.parallel import (build_halo_partition, make_mesh,
                                      make_partitioned_gcn_train,
                                      shard_nodes, sign_precompute,
                                      estimate_hbm_gb, reorder_bandwidth)
    from gammagl_tpu.utils import calc_gcn_norm_np, enable_compile_cache

    enable_compile_cache()

    if args.data_root:
        ei, x, y, train, val, c = load_ogb_root(args.data_root,
                                                args.ogb_name)
    elif args.features:
        ei, x, y, train, val, c = load_real(args)
    else:
        ei, x, y, train, val, c = synthetic_papers(args.scale)
    n, f = x.shape
    ndev = len(jax.devices())
    cdtype = jnp.float32 if args.f32 else jnp.bfloat16
    print(f"graph: {n:,} nodes, {ei.shape[1]:,} edges, {f} feats, "
          f"{c} classes on {ndev} devices")
    print(f"est. HBM/chip: "
          f"{estimate_hbm_gb(n, f, args.hidden, args.layers, ndev, ei.shape[1] / max(n, 1), cdtype, not args.no_remat):.2f} GB")

    if args.rcm:
        perm, inv = reorder_bandwidth(ei, n)
        ei = inv[np.asarray(ei)]
        x, y, train, val = x[perm], y[perm], train[perm], val[perm]

    t0 = time.perf_counter()
    ei = np.concatenate(  # self-loops (reference gcn_trainer does the same)
        [np.asarray(ei), np.tile(np.arange(n, dtype=np.int64), (2, 1))], 1)
    # host-side norm: the full edge list must never land on one device
    w = calc_gcn_norm_np(ei, n)
    if args.slices > 1:
        from gammagl_tpu.parallel import (build_hier_halo_partition,
                                          traffic_report)
        assert ndev % args.slices == 0, (ndev, args.slices)
        dp = ndev // args.slices
        mesh = make_mesh(shape=(args.slices, dp),
                         axis_names=("slice", "dp"))
        part = base = build_hier_halo_partition(
            np.asarray(ei), n, args.slices, dp, w,
            balance=not args.no_balance)
        rep = traffic_report(base, max(f, args.hidden), cdtype)
        print(f"partition: {args.slices}x{dp} mesh, rows/chip "
              f"{base.rows_per:,}, halo intra {base.h_intra:,} / inter "
              f"{base.h_inter:,}; inter-host {rep['inter_host_bytes'] / 1e6:.1f} MB/layer "
              f"(dedup {rep['dedup_factor']:.1f}x vs flat) "
              f"({time.perf_counter() - t0:.1f}s)")
    else:
        mesh = make_mesh(axis_names=("dp",))
        part = build_halo_partition(np.asarray(ei), n, ndev, w,
                                    balance=not args.no_balance)
        print(f"partition: rows/chip {part.rows_per:,}, halo/peer "
              f"{part.halo_per_peer:,}, edges/chip "
              f"{part.edge_index.shape[2]:,} "
              f"({time.perf_counter() - t0:.1f}s)")

    xs = shard_nodes(x, mesh, part, dtype=np.float32)
    ys = shard_nodes(y, mesh, part)
    ms = shard_nodes(train.astype(np.float32), mesh, part)
    vs = shard_nodes(val.astype(np.float32), mesh, part)

    if args.recipe == "gcn":
        params, opt_state, step, eval_logits = make_partitioned_gcn_train(
            mesh, part, f, args.hidden, c, num_layers=args.layers,
            compute_dtype=cdtype, remat=not args.no_remat,
            learning_rate=args.lr)
        start_epoch = 0
        if args.ckpt and osp.exists(args.ckpt):
            from gammagl_tpu.train import load_checkpoint_sharded
            restored, start_epoch = load_checkpoint_sharded(
                args.ckpt, {"params": params, "opt": opt_state})
            params, opt_state = restored["params"], restored["opt"]
            print(f"resumed from {args.ckpt} at epoch {start_epoch}")
        for epoch in range(start_epoch, args.epochs):
            t = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, xs, ys, ms)
            jax.block_until_ready(loss)
            dt = time.perf_counter() - t
            if args.ckpt and (epoch + 1) % args.ckpt_every == 0:
                from gammagl_tpu.train import save_checkpoint_sharded
                save_checkpoint_sharded(
                    args.ckpt, {"params": params, "opt": opt_state},
                    step=epoch + 1)
            if epoch % 5 == 0 or epoch == args.epochs - 1:
                logits = eval_logits(params, xs)
                pred = jnp.argmax(logits, 1)
                va = float((jnp.where(vs > 0, (pred == ys), 0).sum()
                            / jnp.maximum(vs.sum(), 1)))
                print(f"epoch {epoch:3d}  loss {float(loss):.4f}  "
                      f"val acc {va:.4f}  {dt * 1e3:.1f} ms "
                      f"({ei.shape[1] / dt:.3e} edges/s)")
        if args.ckpt:
            from gammagl_tpu.train import save_checkpoint_sharded
            save_checkpoint_sharded(args.ckpt,
                                    {"params": params, "opt": opt_state},
                                    step=args.epochs)
            print(f"checkpoint saved to {args.ckpt}")
    else:  # SIGN
        t = time.perf_counter()
        ops = sign_precompute(mesh, part, xs, args.hops,
                              store_dtype=cdtype)
        feats = jnp.concatenate(ops, axis=1)
        jax.block_until_ready(feats)
        print(f"SIGN precompute ({args.hops} sweeps): "
              f"{time.perf_counter() - t:.2f}s; training is graph-free")

        rng = np.random.default_rng(0)
        d_in = feats.shape[1]
        params = {
            "w1": jnp.asarray(rng.normal(size=(d_in, args.hidden))
                              * (2.0 / d_in) ** 0.5, jnp.float32),
            "b1": jnp.zeros(args.hidden, jnp.float32),
            "w2": jnp.asarray(rng.normal(size=(args.hidden, c))
                              * (2.0 / args.hidden) ** 0.5, jnp.float32),
            "b2": jnp.zeros(c, jnp.float32),
        }
        opt = optax.adamw(args.lr)
        opt_state = opt.init(params)

        def fwd(p, h):
            h = h.astype(cdtype)
            h = jax.nn.relu(h @ p["w1"].astype(cdtype)
                            + p["b1"].astype(cdtype))
            return (h @ p["w2"].astype(cdtype)
                    + p["b2"].astype(cdtype)).astype(jnp.float32)

        @jax.jit
        def step(p, s, h, y, m):
            def loss_fn(p):
                ls = optax.softmax_cross_entropy_with_integer_labels(
                    fwd(p, h), y)
                return (ls * m).sum() / jnp.maximum(m.sum(), 1.0)
            loss, g = jax.value_and_grad(loss_fn)(p)
            up, s = opt.update(g, s, p)
            return optax.apply_updates(p, up), s, loss

        for epoch in range(args.epochs):
            t = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, feats, ys, ms)
            jax.block_until_ready(loss)
            if epoch % 5 == 0 or epoch == args.epochs - 1:
                pred = jnp.argmax(fwd(params, feats), 1)
                va = float((jnp.where(vs > 0, (pred == ys), 0).sum()
                            / jnp.maximum(vs.sum(), 1)))
                print(f"epoch {epoch:3d}  loss {float(loss):.4f}  "
                      f"val acc {va:.4f}  "
                      f"{(time.perf_counter() - t) * 1e3:.1f} ms")
    print("done")


if __name__ == "__main__":
    main()
