"""Multi-device scaling benchmark for the halo-exchange SpMM.

Measures edges/s of `make_halo_spmm` on 1..P devices (the BASELINE target:
>= 75% edges/s scaling efficiency 1 -> N). On a machine without a pod this
runs on virtual CPU devices (functional check of the protocol, not a
hardware number): XLA_FLAGS=--xla_force_host_platform_device_count=8.
"""

import argparse
import os.path as osp
import sys
import time

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))

import numpy as np


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--nodes", type=int, default=20_000)
    parser.add_argument("--edges", type=int, default=200_000)
    parser.add_argument("--feat", type=int, default=64)
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from gammagl_tpu.parallel.halo import (build_halo_partition,
                                           make_halo_spmm)

    rng = np.random.default_rng(0)
    ei = np.stack([rng.integers(0, args.nodes, args.edges),
                   rng.integers(0, args.nodes, args.edges)])
    w = rng.random(args.edges).astype(np.float32)

    devices = jax.devices()
    base_rate = None
    for p in [d for d in (1, 2, 4, 8) if d <= len(devices)]:
        mesh = Mesh(np.asarray(devices[:p]), ("dp",))
        part = build_halo_partition(ei, args.nodes, p, w)
        fn = jax.jit(make_halo_spmm(mesh, part))
        total = part.num_parts * part.rows_per
        xs = [jax.device_put(
            jnp.asarray(rng.normal(size=(total, args.feat)).astype(
                np.float32)), NamedSharding(mesh, P("dp")))
            for _ in range(3)]
        out = fn(xs[0])
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for i in range(args.iters):
            out = fn(xs[i % 3])
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / args.iters
        rate = args.edges / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * p)
        print(f"devices={p}: {dt * 1e3:8.2f} ms  {rate:10.3e} edges/s  "
              f"scaling-eff {eff:5.1%}")

    # two-level (slice x dp) tier: same SpMM over a 2-slice mesh with
    # host-deduped inter-host traffic (parallel/hier_halo.py)
    if len(devices) >= 4:
        from gammagl_tpu.parallel.hier_halo import (
            build_hier_halo_partition, make_hier_halo_spmm, traffic_report)
        S, D = 2, min(4, len(devices) // 2)
        mesh = Mesh(np.asarray(devices[:S * D]).reshape(S, D),
                    ("slice", "dp"))
        part = build_hier_halo_partition(ei, args.nodes, S, D, w)
        fn = jax.jit(make_hier_halo_spmm(mesh, part))
        total = part.num_parts * part.rows_per
        xs = [jax.device_put(
            jnp.asarray(rng.normal(size=(total, args.feat)).astype(
                np.float32)), NamedSharding(mesh, P(("slice", "dp"))))
            for _ in range(3)]
        jax.block_until_ready(fn(xs[0]))
        t0 = time.perf_counter()
        for i in range(args.iters):
            out = fn(xs[i % 3])
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / args.iters
        rep = traffic_report(part, args.feat, jnp.float32)
        print(f"hier {S}x{D}: {dt * 1e3:8.2f} ms  "
              f"{args.edges / dt:10.3e} edges/s  inter-host "
              f"{rep['inter_host_bytes'] / 1e6:.1f} MB/layer "
              f"(dedup {rep['dedup_factor']:.1f}x vs flat)")


if __name__ == "__main__":
    main()
