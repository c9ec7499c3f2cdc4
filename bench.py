"""XLA timings of the message-passing ops on the GPU, with parity checks.

Each op is timed at the shape its old hand-written kernel was benched at
(protocol of the reference kernel bench, profiler/mpops/complete_test:
ogbn-arxiv 169,343 nodes / 2,315,598 edges):

  spmm        F=256, bf16 and f32        (GCN aggregation)
  sddmm       F=256, bf16                (attention scores)
  gat         GATConv F=64, bf16 and f32 (score, edge softmax, aggregate)
  hgt         relation attention, 200k -> 100k nodes, 2M edges, H=4, D=64
  segment_max F=64, bf16 and f32         (aggr="max")

Each case is timed forward and forward+backward (median of `ITERS` calls
after warm-up, each ending in `block_until_ready`), and checked forward and
gradient against the same semantics in plain f32 `jax.numpy` under
`jax.default_matmul_precision("highest")`. The error is
max|got - ref| / max|ref|; each tolerance states its reason.

Needs a GPU: `python bench.py` prints the card, one line per case, and one
JSON line last. `chip_smoke.py` runs the same cases.
"""

import json
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

ITERS = 10
ARXIV = dict(n=169_343, e=2_315_598)
HGT = dict(n_src=200_000, n_dst=100_000, e=2_000_000, heads=4, dim=64)

# Why each comparison may differ, as a share of max|ref|.
TOL = {
    "sum_order": (1e-4, "f32 sums in another order (GPU scatter-add uses "
                        "atomics)"),
    "tf32": (5e-3, "f32 matmuls run in TF32 (about 10 mantissa bits) "
                   "against 'highest'"),
    "bf16": (3e-2, "bf16 inputs and outputs (8 mantissa bits), f32 "
                   "accumulation"),
    "exact": (1e-6, "max of the same f32 values is exact"),
    # GAT's gradient only: rounding moves some edge scores across
    # LeakyReLU's kink, where the slope jumps from 1 to 0.2. Readings on an
    # H100 are in PERF.md: with slope 1.0 the errors fall to the bf16 and
    # TF32 levels above.
    "bf16_kink": (7e-2, "bf16 rounding moves edge scores across "
                        "LeakyReLU's kink"),
    "tf32_kink": (3e-2, "TF32 rounding moves edge scores across "
                        "LeakyReLU's kink"),
}


# -- device and card ---------------------------------------------------------

def require_gpu():
    """The first device, which must be a GPU: a timing taken anywhere else
    says nothing about the card."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {dev.platform!r} "
                         f"({dev.device_kind})")
    return dev


def card_line():
    """`nvidia-smi` name and power limit of the cards, one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


# -- shapes ------------------------------------------------------------------

def arxiv_edges(seed, n=ARXIV["n"], e=ARXIV["e"]):
    """(src, dst) int32 numpy: uniform sources, power-law destinations
    (in-degree skew of a citation graph)."""
    rng = np.random.default_rng(seed)
    dst = (n * (rng.random(e) ** 1.5)).astype(np.int32)
    src = rng.integers(0, n, e).astype(np.int32)
    return src, dst


def rel_err(got, ref):
    got = np.asarray(jnp.asarray(got, jnp.float32), np.float64)
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def tree_err(got, ref):
    return max(rel_err(g, r) for g, r in zip(jax.tree_util.tree_leaves(got),
                                             jax.tree_util.tree_leaves(ref)))


# -- the ops and their plain references ----------------------------------------

def _cases(sizes):
    """[(name, edges, fn, ref_fn, args, ei, tol_key[, grad_tol_key])]:
    `fn(ei, *args)` and `ref_fn(ei, *args)` return arrays, differentiable
    in every float arg; the edges `ei` go in as an argument, as a user's
    step passes them."""
    from gammagl_tpu.layers.conv import GATConv
    from gammagl_tpu.layers.conv.hetero_conv import relation_attention
    from gammagl_tpu.ops import sddmm_dot, spmm

    n, e, f_wide, f_narrow = (sizes["n"], sizes["e"], sizes["f_wide"],
                              sizes["f_narrow"])
    rng = np.random.default_rng(0)
    ei = jnp.asarray(np.stack(arxiv_edges(0, n, e)))

    def ref_spmm(ei, x, w, reduce="sum"):
        msg = x[ei[0]] * w[:, None]
        if reduce == "sum":
            return jax.ops.segment_sum(msg, ei[1], n)
        out = jax.ops.segment_max(msg, ei[1], n)
        return jnp.where(jnp.isneginf(out), 0.0, out)

    cases = []
    xw = rng.normal(size=(n, f_wide)).astype(np.float32)
    w = rng.random(e).astype(np.float32)
    for dt, tol in ((jnp.bfloat16, "bf16"), (jnp.float32, "sum_order")):
        cases.append((f"spmm_{jnp.dtype(dt).name}", e,
                      lambda ei, x, w: spmm(ei, w, x, num_nodes=n),
                      ref_spmm, (jnp.asarray(xw, dt), jnp.asarray(w, dt)),
                      ei, tol))
    xd = rng.normal(size=(n, f_wide)).astype(np.float32)
    cases.append(("sddmm_bfloat16", e, sddmm_dot,
                  lambda ei, a, b: (a[ei[0]] * b[ei[1]]).sum(-1),
                  (jnp.asarray(xw, jnp.bfloat16),
                   jnp.asarray(xd, jnp.bfloat16)), ei, "bf16"))

    xn = rng.normal(size=(n, f_narrow)).astype(np.float32)
    for dt, tol, gtol in ((jnp.bfloat16, "bf16", "bf16_kink"),
                          (jnp.float32, "tf32", "tf32_kink")):
        conv = GATConv(f_narrow, heads=1,
                       dtype=None if dt == jnp.float32 else dt)
        ref_conv = GATConv(f_narrow, heads=1)
        params = conv.init(jax.random.PRNGKey(0), jnp.asarray(xn[:8]),
                           jnp.zeros((2, 1), jnp.int32))["params"]
        cases.append((
            f"gat_{jnp.dtype(dt).name}", e,
            lambda ei, p, x, c=conv: c.apply({"params": p}, x, ei,
                                             num_nodes=n),
            lambda ei, p, x, c=ref_conv: c.apply({"params": p}, x, ei,
                                                 num_nodes=n),
            (params, jnp.asarray(xn, dt)), ei, tol, gtol))

    hs, hd, he = sizes["hgt_src"], sizes["hgt_dst"], sizes["hgt_e"]
    H, D = HGT["heads"], sizes["hgt_dim"]
    hrng = np.random.default_rng(3)
    hei = jnp.asarray(np.stack([
        hrng.integers(0, hs, he),
        (hd * (hrng.random(he) ** 1.3)).astype(np.int64)]).astype(np.int32))
    pri = jnp.ones((H,), jnp.float32)
    qkv = [jnp.asarray(hrng.normal(size=(m, H, D)), jnp.bfloat16)
           for m in (hd, hs, hs)]

    def ref_hgt(ei, q, k, v):
        src, dst = ei[0], ei[1]
        s = (q[dst] * k[src]).sum(-1) / np.sqrt(D)
        m = jax.ops.segment_max(s, dst, hd)
        ex = jnp.exp(s - m[dst])
        a = ex / jax.ops.segment_sum(ex, dst, hd)[dst]
        return jax.ops.segment_sum(v[src] * a[..., None], dst, hd)

    cases.append(("hgt_bfloat16", he,
                  lambda ei, q, k, v: relation_attention(q, k, v, ei, hd,
                                                         pri),
                  ref_hgt, tuple(qkv), hei, "bf16"))

    for dt, tol in ((jnp.bfloat16, "bf16"), (jnp.float32, "exact")):
        cases.append((f"segment_max_{jnp.dtype(dt).name}", e,
                      lambda ei, x: spmm(ei, None, x, num_nodes=n,
                                         reduce="max"),
                      lambda ei, x: ref_spmm(ei, x, jnp.ones(e, x.dtype),
                                             "max"),
                      (jnp.asarray(xn, dt),), ei, tol))
    return cases


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def run_case(name, edges, fn, ref_fn, args, ei, tol_key, grad_tol_key=None,
             iters=ITERS):
    """Time and check one case; raises AssertionError past tolerance."""
    from gammagl_tpu.utils import median_time
    tol, reason = TOL[tol_key]
    gtol, greason = TOL[grad_tol_key or tol_key]
    out = jax.eval_shape(fn, ei, *args)
    # every array goes in as an argument: a closed-over array would be
    # baked into the program as a constant
    ct = jnp.asarray(np.random.default_rng(1).normal(size=out.shape),
                     out.dtype)

    def loss(f, ct, ei, *a):
        return (f(ei, *a).astype(jnp.float32)
                * ct.astype(jnp.float32)).sum()

    argnums = tuple(range(2, len(args) + 2))
    fwd = jax.jit(fn)
    fwd_bwd = jax.jit(jax.value_and_grad(lambda *a: loss(fn, *a),
                                         argnums=argnums))
    t0 = time.perf_counter()
    jax.block_until_ready(fwd_bwd(ct, ei, *args))
    compile_s = time.perf_counter() - t0
    t_fwd, _ = median_time(fwd, ei, *args, iters=iters)
    t_train, _ = median_time(fwd_bwd, ct, ei, *args, iters=iters)

    ref_args = _f32(args)
    with jax.default_matmul_precision("highest"):
        ref_out = jax.jit(ref_fn)(ei, *ref_args)
        ref_grad = jax.jit(jax.grad(lambda *a: loss(ref_fn, *a),
                                    argnums=argnums))(ct, ei, *ref_args)
    _, grad = fwd_bwd(ct, ei, *args)
    err_out = rel_err(fwd(ei, *args), ref_out)
    err_grad = tree_err(grad, ref_grad)
    res = {"case": name, "fwd_ms": t_fwd * 1e3, "fwd_bwd_ms": t_train * 1e3,
           "fwd_edges_per_s": edges / t_fwd,
           "compile_s": compile_s, "err_out": err_out,
           "err_grad": err_grad, "tol": tol, "tol_reason": reason,
           "grad_tol": gtol, "grad_tol_reason": greason}
    assert err_out <= tol and err_grad <= gtol, res
    return res


FULL = dict(n=ARXIV["n"], e=ARXIV["e"], f_wide=256, f_narrow=64,
            hgt_src=HGT["n_src"], hgt_dst=HGT["n_dst"], hgt_e=HGT["e"],
            hgt_dim=HGT["dim"])


def run_ops(sizes=FULL, iters=ITERS, log=print):
    results = []
    for case in _cases(sizes):
        r = run_case(*case, iters=iters)
        log(f"ops {r['case']}: fwd {r['fwd_ms']:.3f} ms "
            f"({r['fwd_edges_per_s']:.4g} edges/s), fwd+bwd "
            f"{r['fwd_bwd_ms']:.3f} ms, compile {r['compile_s']:.1f} s, "
            f"err out {r['err_out']:.2e} <= {r['tol']:.0e} "
            f"({r['tol_reason']}), grad {r['err_grad']:.2e} <= "
            f"{r['grad_tol']:.0e} ({r['grad_tol_reason']})")
        results.append(r)
    return results


def main():
    from gammagl_tpu.utils import enable_compile_cache
    dev = require_gpu()
    cache = enable_compile_cache()
    print(f"card: {card_line()}")
    print(f"device: {dev.platform} {dev.device_kind} x{jax.device_count()}"
          f", compile cache {cache}")
    results = run_ops()
    print(json.dumps({"device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": jax.device_count()},
                      "ops": results}))


if __name__ == "__main__":
    sys.exit(main())
