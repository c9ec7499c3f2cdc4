"""Profiling/timing harness (SURVEY.md section 5).

The reference profiles with ad-hoc `time.time()` deltas in offline scripts
(reference profiler/ggl/gcn_trainer.py:59, ticktock.h for C++). JAX
dispatches asynchronously, so a wall-clock bracket only measures the
device when it ends in `block_until_ready`. `median_time` warms the
function up (compilation is set-up, not step time), then times each call
to completion and reports the median. `trace` wraps `jax.profiler.trace`
for a device timeline viewable in TensorBoard/Perfetto.
"""

import contextlib
import statistics
import time

import jax

__all__ = ["median_time", "trace", "device_timer"]


def median_time(fn, *args, iters=10, warmup=2):
    """(median seconds, all samples) of `fn(*args)` run to completion,
    after `warmup` untimed calls."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples), samples


@contextlib.contextmanager
def trace(logdir):
    """Device timeline capture: `with trace('/tmp/tb'): step()`.

    Open with TensorBoard's profile plugin or Perfetto. Wraps
    `jax.profiler.trace`; the context also blocks on a trailing barrier so
    async dispatch doesn't leak past the capture window.
    """
    with jax.profiler.trace(str(logdir)):
        yield
        # flush pending async work into the trace
        jax.effects_barrier()


@contextlib.contextmanager
def device_timer(label="block", sink=print):
    """Coarse wall-clock bracket with a device barrier on exit (the
    `block_until_ready` timing idiom; for repeated calls prefer
    `median_time`)."""
    t0 = time.perf_counter()
    yield
    jax.effects_barrier()
    sink(f"{label}: {time.perf_counter() - t0:.4f}s")
