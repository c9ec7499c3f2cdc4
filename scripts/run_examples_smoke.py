"""Smoke-run every example trainer (offline synthetic fallbacks) and
report a pass/fail table. Not part of the default pytest tier (each
trainer jit-compiles; the full sweep takes tens of minutes) —
run manually or per-round:

    python scripts/run_examples_smoke.py             # all dirs
    python scripts/run_examples_smoke.py gcn gat     # subset
    python scripts/run_examples_smoke.py --jobs 2    # parallel (CPU only)

Each trainer is run with its default args plus, when supported, a tiny
epoch count; success = exit code 0 within the timeout.
"""

import argparse
import concurrent.futures as cf
import json
import os
import os.path as osp
import subprocess
import sys
import time

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
EX = osp.join(ROOT, "examples")

# trainers that are intentionally long or need flags to stay small
EXTRA_ARGS = {
    "papers100m": ["--scale", "0.0002", "--epochs", "2"],
}
EPOCH_FLAGS = ("--n_epoch", "--epochs", "--n_epochs")


def find_trainer(d):
    path = osp.join(EX, d)
    cands = sorted(f for f in os.listdir(path)
                   if f.endswith("_trainer.py"))
    if not cands:
        cands = sorted(f for f in os.listdir(path) if f.endswith(".py"))
    return osp.join(path, cands[0]) if cands else None


def epoch_args(trainer):
    src = open(trainer, encoding="utf-8").read()
    for flag in EPOCH_FLAGS:
        if f'"{flag}"' in src or f"'{flag}'" in src:
            return [flag, "2"]
    return []


def run_one(d, timeout, force_cpu, real_shapes=False):
    trainer = find_trainer(d)
    if trainer is None:
        return d, "SKIP (no trainer)", 0.0
    extra = EXTRA_ARGS.get(d) or epoch_args(trainer)
    env = dict(os.environ)
    # never let a blackholing resolver stall a trainer mid-smoke
    env.setdefault("GGL_TPU_OFFLINE", "1")
    if real_shapes:
        # synthetic fallbacks pad to true dataset dims (examples/common
        # _REAL_DIMS) so shape-dependent compile bugs surface everywhere
        env["GGL_REAL_SHAPES"] = "1"
    if force_cpu:
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_force_host_platform_device_count=8")
        env["JAX_PLATFORMS"] = "cpu"
    args = [sys.executable, trainer] + extra
    t0 = time.perf_counter()
    try:
        r = subprocess.run(args, capture_output=True, text=True,
                           timeout=timeout, env=env, cwd=ROOT)
        dt = time.perf_counter() - t0
        if r.returncode == 0:
            return d, "OK", dt
        tail = (r.stderr or r.stdout).strip().splitlines()[-1:]
        return d, f"FAIL rc={r.returncode}: {' '.join(tail)[:150]}", dt
    except subprocess.TimeoutExpired:
        return d, f"TIMEOUT >{timeout}s", time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="*", help="example dirs (default all)")
    ap.add_argument("--timeout", type=int, default=420)
    ap.add_argument("--jobs", type=int, default=1,
                    help=">1 requires --cpu (one process per GPU: each "
                         "JAX process reserves most of the card's memory)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (8 virtual devices)")
    ap.add_argument("--real-shapes", action="store_true",
                    help="pad synthetic fallbacks to true dataset dims "
                         "(Cora 1433, Reddit 602, arxiv 128) so "
                         "shape-dependent compile bugs surface")
    ap.add_argument("--json", default=None,
                    help="write per-example {status, seconds} to this "
                         "JSON file (the SMOKE_r* driver artifact)")
    args = ap.parse_args()
    if args.jobs > 1 and not args.cpu:
        ap.error("--jobs > 1 requires --cpu")

    dirs = args.dirs or sorted(
        d for d in os.listdir(EX)
        if osp.isdir(osp.join(EX, d)) and not d.startswith("_"))
    results = []
    if args.jobs > 1:
        with cf.ThreadPoolExecutor(args.jobs) as pool:
            futs = [pool.submit(run_one, d, args.timeout, args.cpu,
                                args.real_shapes)
                    for d in dirs]
            for f in cf.as_completed(futs):
                d, status, dt = f.result()
                print(f"{d:24s} {status:40s} {dt:6.1f}s", flush=True)
                results.append((d, status, dt))
    else:
        for d in dirs:
            d, status, dt = run_one(d, args.timeout, args.cpu,
                                    args.real_shapes)
            print(f"{d:24s} {status:40s} {dt:6.1f}s", flush=True)
            results.append((d, status, dt))
    bad = [r for r in results if not r[1].startswith(("OK", "SKIP"))]
    print(f"\n{len(results) - len(bad)}/{len(results)} passed")
    if args.json:
        import jax
        payload = {
            "backend": "cpu" if args.cpu else jax.default_backend(),
            "real_shapes": bool(args.real_shapes),
            "timeout_s": args.timeout,
            "passed": len(results) - len(bad),
            "total": len(results),
            "examples": {d: {"status": s, "seconds": round(t, 1)}
                         for d, s, t in sorted(results)},
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.json}")
    if bad:
        print("failures:", ", ".join(d for d, *_ in bad))
        sys.exit(1)


if __name__ == "__main__":
    main()
