"""Profiling harness + determinism guarantees (SURVEY.md section 5).

The reference avoids C++/CUDA races with atomics (spmm_sum_cpu.cpp:34-37,
segment_sum_cuda.cu:29) -- atomicAdd float reductions are NOT bitwise
reproducible across runs. XLA's CPU scatter-add has a fixed reduction
order; these tests pin that on the CPU. XLA's GPU scatter-add uses atomics
unless `--xla_gpu_deterministic_ops=true` is in XLA_FLAGS.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp

from gammagl_tpu.utils import median_time, trace, device_timer


def test_median_time_positive():
    t, samples = median_time(jax.jit(lambda h: h * 1.0001),
                             jnp.ones((64, 64)), iters=3, warmup=1)
    assert t > 0 and len(samples) == 3 and min(samples) <= t


def test_trace_writes_profile(tmp_path):
    with trace(tmp_path):
        jnp.dot(jnp.ones((32, 32)), jnp.ones((32, 32))).block_until_ready()
    found = any("perfetto" in f or f.endswith(".pb") or "plugins" in r
                for r, _, fs in os.walk(tmp_path) for f in fs)
    assert found or any(os.scandir(tmp_path))


def test_device_timer_emits(capsys):
    with device_timer("probe"):
        jnp.ones((8,)).sum().block_until_ready()
    assert "probe:" in capsys.readouterr().out


def test_segment_sum_bitwise_deterministic():
    from gammagl_tpu.ops import segment_sum

    rng = np.random.default_rng(1)
    v = jnp.asarray(rng.normal(size=(5000, 16)).astype(np.float32))
    seg = jnp.asarray(rng.integers(0, 100, 5000))
    fn = jax.jit(lambda v: segment_sum(v, seg, 100))
    a, b = np.asarray(fn(v)), np.asarray(fn(v + 0.0))
    assert (a == b).all()
