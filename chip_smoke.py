"""Proof that the library's main path runs on the GPU: one process, one card.

    python chip_smoke.py             # one GPU: device, gcn_train, ops, serve
    python chip_smoke.py --chips 4   # four GPUs: partitioned GCN and GAT only

Phases (one line each, with wall time and numbers):

  device     the card, JAX, package versions, compilers, XLA_FLAGS, the
             compile cache and the native sampler.
  gcn_train  the README quick start at OGB's arxiv GCN baseline width
             (3 layers x 256, 40 classes) on an ogbn-arxiv-shaped graph
             made from --seed: 10 jitted Adam steps in f32 and in bf16; the
             loss must fall; logits and first loss match f32 under
             "highest" precision; layer 1's aggregation matches a float64
             scipy.sparse product.
  ops        bench.py's XLA op timings, each checked forward and gradient.
  serve      InferenceSession answers 8 requests that match model.apply;
             the export_forward program matches the session, and so does
             its save_exported -> load_exported round trip where the
             flatbuffers package (jax.export's serializer) is installed.
  partitioned (--chips N) make_partitioned_gcn_train and
             make_partitioned_gat_train over an N-card halo partition
             against a 1-part partition on card 0.

Any failed check raises, so the exit code is non-zero. The last line is
the JSON object {"ok": true, "device": {...}}; without a GPU the script
exits non-zero before printing it.
"""

import argparse
import importlib.metadata
import importlib.util
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import jax
import jax.numpy as jnp

import bench
from gammagl_tpu.utils import enable_compile_cache

ARXIV = dict(n=bench.ARXIV["n"], e=bench.ARXIV["e"], f=128, classes=40)
# OGB's ogbn-arxiv GCN baseline: 3 layers, 256 hidden, dropout 0.5
MODEL = dict(hidden_dim=256, num_layers=3, drop_rate=0.5)
STEPS = 10
LR = 0.01


class Phase:
    """Prints `[name] <seconds>s <message>` lines for one phase."""

    def __init__(self, name):
        self.name, self.t0 = name, time.perf_counter()

    def __call__(self, msg):
        print(f"[{self.name}] {time.perf_counter() - self.t0:.1f}s {msg}",
              flush=True)


def check(name, err, tol, reason, log):
    log(f"parity {name}: err {err:.3e} <= tol {tol:.0e} ({reason})")
    if not err <= tol:
        raise AssertionError(f"{name}: err {err:.3e} > tol {tol:.0e}")


def node_task(seed, n, e, f, classes, homophily=0.65):
    """ogbn-arxiv-shaped node classification made from `seed`: power-law
    in-degree edges plus self-loops, a `homophily` share of them from a
    node of the destination's class (arxiv's edge homophily is about
    0.65), features = class centre + noise, a 54% train mask (arxiv's
    train share)."""
    src, dst = bench.arxiv_edges(seed, n, e)
    rng = np.random.default_rng(seed + 1)
    y = rng.integers(0, classes, n).astype(np.int32)
    by_class = np.argsort(y, kind="stable")
    start = np.searchsorted(y[by_class], np.arange(classes))
    count = np.bincount(y, minlength=classes)
    same = rng.random(e) < homophily
    c = y[dst[same]]
    src[same] = by_class[start[c] + (rng.random(same.sum())
                                     * count[c]).astype(np.int64)]
    loops = np.arange(n, dtype=np.int32)
    ei = np.stack([np.concatenate([src, loops]),
                   np.concatenate([dst, loops])])
    centres = rng.normal(size=(classes, f)).astype(np.float32)
    x = (rng.normal(size=(n, f)).astype(np.float32) + centres[y])
    train = rng.random(n) < 0.54
    return x, ei, y, train


def gcn_norm_csr(ei, n):
    """float64 scipy CSR of GCNConv's norm='both' propagation matrix."""
    import scipy.sparse as sp
    src, dst = ei[0], ei[1]
    deg_out = np.bincount(src, minlength=n).astype(np.float64)
    deg_in = np.bincount(dst, minlength=n).astype(np.float64)
    w = (np.where(deg_out > 0, deg_out, 1.0) ** -0.5)[src] \
        * (np.where(deg_in > 0, deg_in, 1.0) ** -0.5)[dst]
    return sp.csr_matrix((w, (dst, src)), shape=(n, n))


# -- phases -------------------------------------------------------------------

def phase_device(dev, cache):
    log = Phase("device")
    log(f"card: {bench.card_line()}")
    log(f"jax.devices(): {jax.devices()}")
    jax.print_environment_info()
    for pkg in ("flax", "optax", "orbax-checkpoint", "msgpack",
                "flatbuffers", "scipy", "numpy"):
        try:
            ver = importlib.metadata.version(pkg)
        except importlib.metadata.PackageNotFoundError:
            ver = "not installed"
        log(f"package {pkg}: {ver}")
    for cmd in (["g++", "--version"], ["nvcc", "--version"]):
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=60).stdout.strip().splitlines()
            log(f"{cmd[0]}: {out[0] if cmd[0] == 'g++' else out[-1]}")
        except (OSError, IndexError):
            log(f"{cmd[0]}: not found")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    n_entries = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    log(f"compile cache {cache}: {n_entries} entries at start")
    from gammagl_tpu import csrc
    log(f"native sampler loaded: {csrc.available()}")
    log(f"device {dev.platform} {dev.device_kind} x{jax.device_count()}")


def train_gcn(task, dtype, steps=STEPS, seed=0):
    """The README quick start: GCNModel + TrainState + semi_supervised_loss
    + optax Adam, `steps` jitted steps. Returns a dict of results."""
    import optax
    from gammagl_tpu.models import GCNModel
    from gammagl_tpu.train import TrainState, semi_supervised_loss

    data = tuple(jnp.asarray(a) for a in task)   # jit args, not constants
    classes = int(task[2].max()) + 1
    model = GCNModel(num_class=classes, dtype=dtype, **MODEL)
    params = model.init(jax.random.PRNGKey(seed), data[0], data[1])
    state = TrainState.create(params=params, tx=optax.adam(LR))

    def loss_fn(p, key, x, ei, y, train, model=model):
        logits = model.apply(p, x, ei, train=True, rngs={"dropout": key})
        return semi_supervised_loss(logits, y, train)

    def step(state, key, *data):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, key, *data)
        return state.apply_gradients(grads), loss

    keys = jax.random.split(jax.random.PRNGKey(seed + 1), steps)
    t0 = time.perf_counter()
    compiled = jax.jit(step).lower(state, keys[0], *data).compile()
    compile_s = time.perf_counter() - t0
    losses, times = [], []
    for k in keys:
        t0 = time.perf_counter()
        state, loss = compiled(state, k, *data)
        loss = float(jax.block_until_ready(loss))
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    mem = compiled.memory_analysis()
    return dict(model=model, params=params, state=state, losses=losses,
                step_s=float(np.median(times[1:])), compile_s=compile_s,
                temp_bytes=getattr(mem, "temp_size_in_bytes", None),
                arg_bytes=getattr(mem, "argument_size_in_bytes", None),
                loss_fn=loss_fn, first_key=keys[0], data=data)


def phase_gcn_train(task, log=None):
    from gammagl_tpu.layers.conv import GCNConv
    log = log or Phase("gcn_train")
    x, ei, y, train = task
    runs = {}
    for dtype, tol_key in ((jnp.float32, "tf32"), (jnp.bfloat16, "bf16")):
        name = jnp.dtype(dtype).name
        r = train_gcn(task, None if dtype == jnp.float32 else dtype)
        runs[name] = r
        log(f"{name}: losses {' '.join(f'{v:.4f}' for v in r['losses'])}")
        log(f"{name}: median step {r['step_s'] * 1e3:.3f} ms "
            f"({ei.shape[1] / r['step_s']:.4g} edges/s), compile "
            f"{r['compile_s']:.1f} s, memory_analysis temp "
            f"{r['temp_bytes']} B args {r['arg_bytes']} B")
        if not r["losses"][-1] < r["losses"][0]:
            raise AssertionError(f"{name} loss did not fall: {r['losses']}")
        # parity at init against f32 under "highest" precision
        ref, data = runs["float32"], r["data"]
        got = jax.jit(r["model"].apply)(r["params"], *data[:2])
        got_loss = jax.jit(r["loss_fn"])(r["params"], r["first_key"], *data)
        with jax.default_matmul_precision("highest"):
            want = jax.jit(ref["model"].apply)(r["params"], *data[:2])
            want_loss = jax.jit(ref["loss_fn"])(r["params"], r["first_key"],
                                                *data)
        tol, reason = bench.TOL[tol_key]
        check(f"{name} logits vs f32 highest", bench.rel_err(got, want),
              tol, reason, log)
        check(f"{name} first loss vs f32 highest",
              abs(float(got_loss) - float(want_loss)) / abs(float(want_loss)),
              tol, reason, log)
    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    log(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")

    # layer 1's aggregation against a float64 scipy CSR product on the host
    p1 = runs["float32"]["params"]["params"]["GCNConv_0"]
    conv = GCNConv(MODEL["hidden_dim"])
    with jax.default_matmul_precision("highest"):
        agg = jax.jit(conv.apply)({"params": p1}, jnp.asarray(x),
                                  jnp.asarray(ei))
    h = x.astype(np.float64) @ np.asarray(p1["Dense_0"]["kernel"],
                                          np.float64)
    want = gcn_norm_csr(ei, x.shape[0]) @ h + np.asarray(p1["bias"],
                                                          np.float64)
    check("layer-1 aggregation vs scipy float64", bench.rel_err(agg, want),
          *bench.TOL["sum_order"], log)
    return runs["float32"]


def phase_serve(task, run, requests=8, log=None):
    from gammagl_tpu.serve import (InferenceSession, export_forward,
                                   load_exported, save_exported)
    log = log or Phase("serve")
    model, params = run["model"], run["state"].params
    x, ei = jnp.asarray(task[0]), jnp.asarray(task[1])
    t0 = time.perf_counter()
    sess = InferenceSession(model.apply, params, (x, ei))
    log(f"InferenceSession compiled in {time.perf_counter() - t0:.1f} s")
    direct = jax.jit(model.apply)
    noise = jax.random.normal(jax.random.PRNGKey(7), x.shape, x.dtype)
    tol, reason = bench.TOL["sum_order"]
    lat, worst = [], 0.0
    for i in range(requests):
        xi = jax.block_until_ready(x + 0.1 * i * noise)
        t0 = time.perf_counter()
        out = jax.block_until_ready(sess(xi, ei))
        lat.append(time.perf_counter() - t0)
        worst = max(worst, bench.rel_err(out, direct(params, xi, ei)))
    log(f"{requests} requests: median latency "
        f"{np.median(lat) * 1e3:.3f} ms, max {max(lat) * 1e3:.3f} ms")
    check(f"{requests} session answers vs model.apply", worst, tol, reason,
          log)
    blob = export_forward(model.apply, params, (x, ei))
    check(f"exported program ({', '.join(blob.platforms)}) vs session",
          bench.rel_err(blob.call(x, ei), sess(x, ei)), tol, reason, log)
    if importlib.util.find_spec("flatbuffers") is None:
        log("save_exported -> load_exported: not run, jax.export's "
            "serializer needs the flatbuffers package, which is not "
            "installed")
        return
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "gcn.stablehlo")
        save_exported(blob, path)
        size = os.path.getsize(path)
        loaded = load_exported(path)
    check(f"reloaded artifact ({size} bytes) vs session",
          bench.rel_err(loaded.call(x, ei), sess(x, ei)), tol, reason, log)


def _masked_ce(logits, y, mask):
    import optax
    ls = optax.softmax_cross_entropy_with_integer_labels(
        logits.astype(jnp.float32), y)
    m = mask.astype(jnp.float32)
    return (ls * m).sum() / jnp.maximum(m.sum(), 1.0)


def partitioned_run(task, recipe, devices, steps=5):
    """Loss and grads at init, then the losses of `steps` train steps, of
    the partitioned `recipe` ("gcn" | "gat") over `devices`, in f32 with
    "highest" matmuls (the comparison is of the partitioning alone)."""
    from gammagl_tpu.parallel import (build_halo_partition,
                                      build_halo_partition_attn, make_mesh,
                                      make_partitioned_gat_train,
                                      make_partitioned_gcn_train,
                                      shard_nodes)
    from gammagl_tpu.utils import calc_gcn_norm_np
    x, ei, y, train = task
    n, f = x.shape
    classes = int(y.max()) + 1
    mesh = make_mesh(devices=list(devices), axis_names=("dp",))
    parts = len(devices)
    if recipe == "gcn":
        part = build_halo_partition(ei, n, parts, calc_gcn_norm_np(ei, n))
        make = make_partitioned_gcn_train
        kw = dict(hidden_dim=MODEL["hidden_dim"],
                  num_layers=MODEL["num_layers"])
    else:
        part = build_halo_partition_attn(ei, n, parts)
        make = make_partitioned_gat_train
        kw = dict(hidden_dim=64, heads=4, num_layers=MODEL["num_layers"])
    xs = shard_nodes(x, mesh, part)
    ys = shard_nodes(y, mesh, part)
    ms = shard_nodes(train.astype(np.float32), mesh, part)
    with jax.default_matmul_precision("highest"):
        params, opt_state, step, eval_logits = make(
            mesh, part, f, num_classes=classes, compute_dtype=jnp.float32,
            learning_rate=LR, seed=0, **kw)
        loss0, grads = jax.jit(jax.value_and_grad(
            lambda p: _masked_ce(eval_logits(p, xs), ys, ms)))(params)
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, xs, ys, ms)
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
    # the first step compiles
    return dict(loss0=float(loss0), grads=grads, losses=losses,
                step_s=float(np.median(times[1:])))


def phase_partitioned(task, ndev, log=None):
    log = log or Phase("partitioned")
    devices = jax.devices()[:ndev]
    if len(devices) < ndev:
        raise SystemExit(f"--chips {ndev} needs {ndev} devices, found "
                         f"{len(devices)}")
    for recipe in ("gcn", "gat"):
        many = partitioned_run(task, recipe, devices)
        one = partitioned_run(task, recipe, devices[:1])
        log(f"{recipe}: {ndev}-part losses "
            f"{' '.join(f'{v:.6f}' for v in many['losses'])} (median step "
            f"{many['step_s'] * 1e3:.3f} ms); 1-part "
            f"{' '.join(f'{v:.6f}' for v in one['losses'])} (median step "
            f"{one['step_s'] * 1e3:.3f} ms)")
        check(f"{recipe} step-1 loss {ndev}-part vs 1-part",
              abs(many["loss0"] - one["loss0"]) / abs(one["loss0"]),
              1e-4, "f32 sums in another order", log)
        for path, g in jax.tree_util.tree_leaves_with_path(many["grads"]):
            ref = one["grads"]
            for k in path:
                ref = ref[k.key]
            check(f"{recipe} grad {jax.tree_util.keystr(path)}",
                  bench.rel_err(g, ref), 1e-3,
                  "f32 sums in another order through 3 layers and back",
                  log)
        check(f"{recipe} loss after 5 steps",
              abs(many["losses"][-1] - one["losses"][-1])
              / abs(one["losses"][-1]), 1e-3,
              "f32 sums in another order, carried through 5 Adam steps",
              log)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devices]
    log(f"peak_bytes_in_use per device: {peaks}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1,
                    help=">1: run only the partitioned phase on that many "
                         "cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = bench.require_gpu()
    cache = enable_compile_cache()
    phase_device(dev, cache)
    task = node_task(args.seed, **ARXIV)
    if args.chips > 1:
        phase_partitioned(task, args.chips)
    else:
        run = phase_gcn_train(task)
        bench.run_ops(log=Phase("ops"))
        phase_serve(task, run)
    n_entries = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    print(f"compile cache {cache}: {n_entries} entries at end")
    print(bench.card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": jax.device_count()}}))


if __name__ == "__main__":
    main()
