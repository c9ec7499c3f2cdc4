"""Kernel micro-benchmarks: segment ops + SpMM across sizes and dims.

Mirrors the reference protocol (reference profiler/mpops/complete_test/
README.md: Cora 2,708n/13,264e; PubMed 19,717n/108,368e; ogbn-arxiv
169,343n/2,315,598e; feature dims {16,64,256}; repeated iterations),
timing the XLA ops (median of --iters calls, each ending in
`block_until_ready`) on the current default device.

Usage: python profiler/kernel_bench.py [--dims 16 64 256] [--iters 10]
"""

import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

GRAPHS = {
    "cora": (2_708, 13_264),
    "pubmed": (19_717, 108_368),
    "ogbn-arxiv": (169_343, 2_315_598),
}


def graph_structure(name, rng):
    """(src, dst, N, tag): REAL adjacency for cora/citeseer/pubmed when
    the reference's bundled CSR files are present (datasets/
    real_structure.py — power-law degree skew and genuine gather
    locality instead of uniform-random synthetic), synthetic power-law
    otherwise."""
    from gammagl_tpu.datasets import load_real_structure
    if name in ("cora", "citeseer", "pubmed"):
        ei, n, is_real = load_real_structure(name)
        if is_real:
            return ei[0], ei[1], n, f"{name}*"
    N, E = GRAPHS[name]
    src = rng.integers(0, N, E)
    dst = (N * (rng.random(E) ** 1.5)).astype(np.int64)
    return src, dst, N, name


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dims", type=int, nargs="+", default=[16, 64, 256])
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--graphs", nargs="+", default=list(GRAPHS))
    args = parser.parse_args()

    from gammagl_tpu.ops import (sddmm_dot, spmm, unsorted_segment_max,
                                 unsorted_segment_mean,
                                 unsorted_segment_sum)
    from gammagl_tpu.utils import median_time

    rng = np.random.default_rng(0)
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind}")
    print(f"{'graph':>12} {'F':>4} {'op':>6} {'ms':>10} {'edges/s':>12}")
    for name in args.graphs:
        src, dst, N, name = graph_structure(name, rng)
        E = len(src)
        ei = jnp.asarray(np.stack([src, dst]).astype(np.int32))
        dj = jnp.asarray(dst.astype(np.int32))
        wj = jnp.asarray(rng.random(E).astype(np.float32))
        for F in args.dims:
            x = jnp.asarray(rng.normal(size=(N, F)).astype(np.float32))
            y = jnp.asarray(rng.normal(size=(N, F)).astype(np.float32))
            m = jnp.asarray(rng.normal(size=(E, F)).astype(np.float32))
            ops = {
                "spmm": (jax.jit(lambda x: spmm(ei, wj, x, num_nodes=N)),
                         (x,)),
                "sddmm": (jax.jit(lambda a, b: sddmm_dot(ei, a, b)),
                          (x, y)),
                # the reference mpops complete_test unsorted_segment tier
                "sum": (jax.jit(lambda m: unsorted_segment_sum(m, dj, N)),
                        (m,)),
                "mean": (jax.jit(lambda m: unsorted_segment_mean(m, dj, N)),
                         (m,)),
                "max": (jax.jit(lambda m: unsorted_segment_max(m, dj, N)),
                        (m,)),
            }
            for op_name, (fn, fargs) in ops.items():
                t, _ = median_time(fn, *fargs, iters=args.iters)
                print(f"{name:>12} {F:>4} {op_name:>6} {t * 1e3:>10.3f} "
                      f"{E / t:>12.3e}")


if __name__ == "__main__":
    main()
