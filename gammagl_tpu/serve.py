"""Serving: ahead-of-time compiled, serializable GNN inference.

The reference has no deployment story beyond pickled weights
(SURVEY.md §5 — `net.save_weights` npz files that need the full Python
stack to use). Serving here is different in kind: a jitted forward
with params baked in exports to a **StableHLO artifact** (`jax.export`)
that reloads and runs without the model's Python code, or AOT-compiles
in-process so the first request pays no trace/compile latency.

    sess = InferenceSession(model.apply, params, (x, edge_index))
    logits = sess(x, edge_index)          # AOT-compiled, zero warmup

    blob = export_forward(model.apply, params, (x, edge_index))
    save_exported(blob, "gcn.stablehlo")  # ship this file
    logits = load_exported("gcn.stablehlo").call(x, edge_index)

Shapes are static per artifact — the padding/bucketing discipline used
for training (`data/padding.py`) is exactly what makes fixed-shape
serving artifacts possible: export one artifact per bucket.
"""

import queue
import threading
import time

import numpy as np
from concurrent.futures import Future
from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax import export as _export
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["export_forward", "save_exported", "load_exported",
           "InferenceSession", "ShardedInferenceSession", "MicroBatcher"]


def _specs(example_inputs):
    return tuple(jax.ShapeDtypeStruct(jnp.shape(a), jnp.asarray(a).dtype)
                 for a in example_inputs)


def export_forward(apply_fn: Callable, params: Any,
                   example_inputs: Sequence, platforms=None,
                   **apply_kwargs):
    """Export `apply_fn(params, *inputs, **apply_kwargs)` with the params
    baked in as constants. Returns a `jax.export.Exported` (write it with
    `save_exported`). `platforms` e.g. ("cuda",) or ("cpu", "cuda") for a
    multi-platform artifact; defaults to the current backend."""
    fn = jax.jit(lambda *inputs: apply_fn(params, *inputs,
                                          **apply_kwargs))
    kw = {"platforms": platforms} if platforms else {}
    return _export.export(fn, **kw)(*_specs(example_inputs))


def save_exported(exported, path):
    """Write a serialized export artifact (StableHLO + calling
    convention) to disk. `jax.export`'s serializer needs the
    `flatbuffers` package."""
    with open(path, "wb") as f:
        f.write(exported.serialize())


def load_exported(path):
    """Reload an artifact written by `save_exported`; `.call(*inputs)` runs
    it on the current backend (no model Python code needed)."""
    with open(path, "rb") as f:
        return _export.deserialize(f.read())


class InferenceSession:
    """In-process AOT-compiled forward: trace + compile happen at
    construction, so the first request runs at steady-state latency.

    compute_dtype: cast float inputs (e.g. bf16 features halve the
    gather traffic); the output is returned as produced
    by the model (typically f32 logits).
    donate: donate input buffers of the listed argument positions
    (serving loops that overwrite their input each request).
    """

    def __init__(self, apply_fn, params, example_inputs,
                 compute_dtype=None, donate_argnums=(), **apply_kwargs):
        self.compute_dtype = compute_dtype

        def fwd(*inputs):
            if compute_dtype is not None:
                inputs = tuple(
                    a.astype(compute_dtype)
                    if jnp.issubdtype(a.dtype, jnp.floating) else a
                    for a in inputs)
            return apply_fn(params, *inputs, **apply_kwargs)

        jitted = jax.jit(fwd, donate_argnums=donate_argnums)
        self._compiled = jitted.lower(*_specs(example_inputs)).compile()

    @property
    def cost_analysis(self):
        return self._compiled.cost_analysis()

    @property
    def memory_analysis(self):
        return self._compiled.memory_analysis()

    def __call__(self, *inputs):
        return self._compiled(*inputs)


class ShardedInferenceSession:
    """Multi-chip AOT inference: one pjit program over a named mesh.

    The single-chip `InferenceSession` replicates everything; this tier
    spreads the forward over a mesh — e.g. features node-sharded over
    'dp' for full-graph serving, or the batch axis sharded for bulk
    scoring — with XLA inserting the collectives. Params are placed per
    `param_spec` (default replicated) and baked into the program.

        mesh = make_mesh(axis_names=("dp",))
        sess = ShardedInferenceSession(
            model.apply, params, (x, ei), mesh,
            in_specs=(P("dp"), P()), out_specs=P("dp"))
        logits = sess(x, ei)        # accepts host or sharded arrays

    `export()` returns a `jax.export.Exported` of the SAME sharded
    program (SPMD partitioning recorded in the artifact); it reloads
    with `load_exported` on any runtime with `mesh.size` devices.
    """

    def __init__(self, apply_fn, params, example_inputs, mesh: Mesh,
                 in_specs, out_specs=None, param_spec=PartitionSpec(),
                 compute_dtype=None, **apply_kwargs):
        self.mesh = mesh
        in_specs = tuple(in_specs)
        if len(in_specs) != len(tuple(example_inputs)):
            raise ValueError("in_specs must match example_inputs")
        self._in_shardings = tuple(NamedSharding(mesh, s) for s in in_specs)
        params = jax.device_put(params, NamedSharding(mesh, param_spec))

        def fwd(*inputs):
            if compute_dtype is not None:
                inputs = tuple(
                    a.astype(compute_dtype)
                    if jnp.issubdtype(a.dtype, jnp.floating) else a
                    for a in inputs)
            return apply_fn(params, *inputs, **apply_kwargs)

        out_shardings = (None if out_specs is None else
                         jax.tree_util.tree_map(
                             lambda s: NamedSharding(mesh, s), out_specs,
                             is_leaf=lambda s: isinstance(s, PartitionSpec)))
        self._jitted = jax.jit(fwd, in_shardings=self._in_shardings,
                               out_shardings=out_shardings)
        specs = _specs(example_inputs)
        self._compiled = self._jitted.lower(*specs).compile()
        self._specs = specs

    @property
    def cost_analysis(self):
        return self._compiled.cost_analysis()

    @property
    def memory_analysis(self):
        return self._compiled.memory_analysis()

    def device_put(self, *inputs):
        """Pre-shard inputs onto the mesh (optional — `__call__` also
        accepts host arrays and lets the runtime transfer)."""
        return tuple(jax.device_put(a, s)
                     for a, s in zip(inputs, self._in_shardings))

    def __call__(self, *inputs):
        return self._compiled(*self.device_put(*inputs))

    def export(self, platforms=None):
        """Export the sharded program (StableHLO + SPMD shardings)."""
        kw = {"platforms": platforms} if platforms else {}
        return _export.export(self._jitted, **kw)(*self._specs)


class MicroBatcher:
    """Request-batching queue: concurrent single requests ride one padded
    device batch (net-new; the reference serves nothing, SURVEY.md §5).

    Submitted items are pytrees whose leaves stack along a new leading
    axis. The worker drains the queue, pads the stack to the smallest
    bucket in `buckets`, and calls ``run_fn(batch, n_valid)`` — typically
    a closure over per-bucket `InferenceSession`s so every bucket is an
    AOT-compiled program. Outputs (leading axis = bucket size) are split
    back to per-request futures.

        mb = MicroBatcher(run, buckets=(8, 32, 128), linger_ms=2.0)
        fut = mb.submit(seed_ids)        # -> concurrent.futures.Future
        result = fut.result()

    `linger_ms` trades tail latency for batch occupancy: the worker
    waits that long after the first pending request before launching a
    partial batch; a full max-bucket batch launches immediately.
    """

    def __init__(self, run_fn: Callable, buckets: Sequence[int],
                 linger_ms: float = 2.0, max_queue: int = 4096):
        self.run_fn = run_fn
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets:
            raise ValueError("need at least one bucket size")
        self.linger_s = float(linger_ms) / 1e3
        self._q = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, item) -> Future:
        fut = Future()
        self._q.put((item, fut))
        return fut

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker ----------------------------------------------------------
    def _take_batch(self):
        cap = self.buckets[-1]
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.linger_s
        while len(batch) < cap:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                batch.append(self._q.get(timeout=left))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        while not self._stop.is_set():
            batch = self._take_batch()
            if not batch:
                continue
            items, futs = zip(*batch)
            n = len(items)
            bucket = next(b for b in self.buckets if b >= n)
            try:
                # batching is HOST-side numpy: per-item device ops would
                # each pay a dispatch
                def _stack(*ls):
                    arr = np.stack([np.asarray(l) for l in ls])
                    if bucket > n:
                        pad = np.zeros((bucket - n,) + arr.shape[1:],
                                       arr.dtype)
                        arr = np.concatenate([arr, pad], axis=0)
                    return arr

                stacked = jax.tree_util.tree_map(_stack, *items)
                out = self.run_fn(stacked, n)
                out = jax.tree_util.tree_map(np.asarray, out)  # one fetch
                rows = [jax.tree_util.tree_map(lambda a: a[i], out)
                        for i in range(n)]
                for fut, row in zip(futs, rows):
                    fut.set_result(row)
            except Exception as e:  # propagate to every waiter
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)
