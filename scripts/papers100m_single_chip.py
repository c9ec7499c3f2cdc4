"""papers100M single-device sustained demo.

Builds the largest per-device shard of a papers100M-shaped graph that fits
a share of the device's memory (`memory_stats()["bytes_limit"]`, sized
with `parallel.estimate_hbm_gb`), trains an L-layer partitioned GCN on the
flat halo tier for N epochs, and records sustained ms/epoch + effective
edges/s as JSON.

The BASELINE.json target line is "GCN epoch time on ogbn-papers100M".
The reference (BUPT-GAMMA/GammaGL) has NO full-graph story at this scale
— its largest-graph path is host-side neighbor sampling
(reference gammagl/ops/sparse/cpu/neighbor_sample.cpp) — so the artifact
also extrapolates the measured per-chip rate to the full 1.62B-edge
graph on the fewest devices that hold it.

    python scripts/papers100m_single_chip.py --out chiprun_out/papers100m.json
"""

import argparse
import json
import os.path as osp
import sys
import time

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))
sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), "..",
                            "examples"))

import numpy as np

PAPERS_N = 111_059_956
PAPERS_E = 1_615_685_872
AVG_DEG = PAPERS_E / PAPERS_N


def solve_scale(hbm_gb, feat_dim, hidden, layers):
    """Largest synthetic scale whose 1-chip estimate fits `hbm_gb`.

    estimate_hbm_gb is linear in num_nodes at fixed degree, so one
    evaluation calibrates the slope (features reside bf16 on device).
    """
    import jax.numpy as jnp
    from gammagl_tpu.parallel import estimate_hbm_gb

    probe_n = 1_000_000
    gb = estimate_hbm_gb(probe_n, feat_dim, hidden, layers, 1, AVG_DEG,
                         jnp.bfloat16, True)
    n = int(probe_n * hbm_gb / float(gb))
    return n / PAPERS_N


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mem-frac", type=float, default=0.5,
                    help="share of the device's bytes_limit the shard's "
                    "estimate may take (the rest is XLA scratch)")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--feat-dim", type=int, default=128)
    ap.add_argument("--scale", type=float, default=None,
                    help="override the HBM-solved shard scale")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--monolithic", action="store_true",
                    help="single-jit train step (the staged per-layer "
                    "default fits ~1.5x larger shards; see "
                    "make_partitioned_gcn_train_staged)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from papers100m.papers100m_trainer import synthetic_papers
    from gammagl_tpu.parallel import (build_halo_partition,
                                      estimate_hbm_gb, hw_model, make_mesh,
                                      make_partitioned_gcn_train,
                                      shard_nodes)
    from gammagl_tpu.utils import calc_gcn_norm_np, enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    hw = hw_model(dev.device_kind)
    budget_gb = args.mem_frac * dev.memory_stats()["bytes_limit"] / 1e9
    scale = args.scale or solve_scale(budget_gb, args.feat_dim,
                                      args.hidden, args.layers)
    t0 = time.perf_counter()
    ei, x, y, train, val, c = synthetic_papers(scale)
    n, f = x.shape
    est = estimate_hbm_gb(n, f, args.hidden, args.layers, 1, AVG_DEG,
                          jnp.bfloat16, True)
    print(f"shard: scale {scale:.5f} -> {n:,} nodes, {ei.shape[1]:,} "
          f"edges; est {est:.2f} GB on "
          f"{jax.devices()[0].device_kind} "
          f"(gen {time.perf_counter() - t0:.1f}s)", flush=True)

    t0 = time.perf_counter()
    ei = np.concatenate(
        [np.asarray(ei), np.tile(np.arange(n, dtype=np.int64), (2, 1))], 1)
    w = calc_gcn_norm_np(ei, n)
    mesh = make_mesh(devices=[dev], axis_names=("dp",))
    part = build_halo_partition(ei, n, 1, w)
    print(f"partition: {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    # bf16 feature residency: the trainer consumes features in
    # compute_dtype anyway and real papers100M ships fp16 features
    import jax.numpy as _jnp
    xs = shard_nodes(x, mesh, part, dtype=_jnp.bfloat16)
    ys = shard_nodes(y, mesh, part)
    ms = shard_nodes(train.astype(np.float32), mesh, part)
    jax.block_until_ready((xs, ys, ms))
    gb = xs.nbytes / 1e9
    dt = time.perf_counter() - t0
    print(f"transfer: {gb:.2f} GB in {dt:.1f}s "
          f"({gb / dt * 1e3:.0f} MB/s)", flush=True)
    del x
    if args.monolithic:
        params, opt_state, step, eval_logits = make_partitioned_gcn_train(
            mesh, part, f, args.hidden, c, num_layers=args.layers,
            compute_dtype=jnp.bfloat16, remat=True, learning_rate=1e-2)
    else:
        from gammagl_tpu.parallel import make_partitioned_gcn_train_staged
        params, opt_state, step, eval_logits = \
            make_partitioned_gcn_train_staged(
                mesh, part, f, args.hidden, c, num_layers=args.layers,
                compute_dtype=jnp.bfloat16, learning_rate=1e-2)
    times = []
    for epoch in range(args.epochs):
        t = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, xs, ys, ms)
        jax.block_until_ready(loss)
        dt = time.perf_counter() - t
        times.append(dt)
        print(f"epoch {epoch:3d}  loss {float(loss):.4f}  "
              f"{dt * 1e3:.1f} ms  ({ei.shape[1] / dt:.3e} edges/s)",
              flush=True)

    sustained = sorted(times[2:])[len(times[2:]) // 2]  # median, post-jit
    eps = ei.shape[1] / sustained
    chips_for_full = -(-PAPERS_N // n)
    # per-layer epoch work scales with local edges; the halo roofline
    # (parallel/scaling.py) gives the efficiency multiplier for the
    # extrapolation. The measured whole-step edge rate is the compute
    # term: it is FASTER than any single layer's SpMM pass, which
    # overstates t_comm relative to t_compute -> a conservative estimate
    from gammagl_tpu.parallel.scaling import halo_scaling_estimate
    rows_full = -(-PAPERS_N // chips_for_full)
    roof = halo_scaling_estimate(
        num_parts=chips_for_full,
        edges_per_part=-(-PAPERS_E // chips_for_full),
        halo_rows_sent=rows_full,  # worst: every owned row is halo
        feat_dim=args.hidden, spmm_edges_per_s=eps, hw=hw,
        total_edges=PAPERS_E)
    eff = roof["efficiency"]
    full_epoch_s = PAPERS_E / (eps * chips_for_full * eff)
    payload = {
        "metric": "papers100m_gcn_epoch",
        "shard_nodes": int(n), "shard_edges": int(ei.shape[1]),
        "scale": scale, "layers": args.layers, "hidden": args.hidden,
        "feat_dim": f, "dtype": "bfloat16", "tier": "flat",
        "device_kind": dev.device_kind,
        "sustained_epoch_ms": round(sustained * 1e3, 1),
        "edges_per_s_per_chip": int(eps),
        "est_hbm_gb": round(float(est), 2),
        "extrapolated_full_graph": {
            "chips": int(chips_for_full),
            "scaling_efficiency_model": round(float(eff), 3),
            "epoch_s": round(full_epoch_s, 2),
        },
        "reference_counterpart": "none (GammaGL has no full-graph "
                                 "multi-chip training; SURVEY.md §2.10)",
    }
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1)
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
