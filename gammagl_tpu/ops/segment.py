"""Segment reductions -- the scatter-aggregate primitive of message passing.

The replacement for the reference's multi-backend mpops dispatch
(reference: gammagl/mpops/torch.py:43,99,159 `unsorted_segment_{sum,mean,max}`
and the C++/CUDA torch_ext kernels gammagl/mpops/torch_ext/src/segment_sum.cpp).
On XLA all of these lower to a single scatter-add/max; the hand-written
backward passes of the reference (gather for sum, argmax-scatter for max)
fall out of JAX autodiff for free and fuse under jit.

Padding convention: edges padded with ``segment_ids == num_segments`` (or any
out-of-range id) are dropped by XLA scatter semantics, so masked/padded edge
blocks are exact no-ops in every reduction.
"""

from functools import partial

import jax
import jax.numpy as jnp

__all__ = [
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "unsorted_segment_sum",
    "unsorted_segment_mean",
    "unsorted_segment_max",
    "unsorted_segment_min",
    "segment_count",
    "gather_rows",
]


def _expand_ids(segment_ids, data):
    """Broadcast 1-D segment ids against leading axis of ``data``."""
    if segment_ids.ndim != 1:
        raise ValueError("segment_ids must be 1-D, got shape "
                         f"{segment_ids.shape}")
    if segment_ids.shape[0] != data.shape[0]:
        raise ValueError(
            f"segment_ids length {segment_ids.shape[0]} != data leading dim "
            f"{data.shape[0]}")
    return segment_ids


def _narrow_float(dtype):
    return (jnp.issubdtype(dtype, jnp.floating)
            and jnp.finfo(dtype).bits < 32)


def accum_dtype(dtype):
    """The dtype that products and sums of `dtype` data are formed in:
    f32 for bf16/f16, else `dtype` itself."""
    return jnp.float32 if _narrow_float(dtype) else dtype


def _sum(data, segment_ids, num_segments):
    """jax.ops.segment_sum that accumulates sub-f32 floats in f32 (a bf16
    accumulator loses the sum of a high in-degree row); the result keeps
    the input dtype."""
    if _narrow_float(data.dtype):
        return jax.ops.segment_sum(
            data.astype(jnp.float32), segment_ids,
            num_segments=num_segments).astype(data.dtype)
    return jax.ops.segment_sum(data, segment_ids, num_segments=num_segments)


def _take(x, idx):
    return jnp.take(x, idx, axis=0, mode="clip")


@jax.custom_jvp
def _take_f32_grad(x, idx):
    return _take(x, idx)


@_take_f32_grad.defjvp
def _take_f32_grad_jvp(primals, tangents):
    # The tangent is gathered in f32, so its transpose -- the gradient, a
    # scatter-add over `idx` -- accumulates in f32 like `_sum`.
    x, idx = primals
    t = tangents[0]
    return (_take_f32_grad(x, idx),
            _take(t.astype(jnp.float32), idx).astype(t.dtype))


def gather_rows(x, idx):
    """``x[idx]`` along axis 0, out-of-range ids clamped.

    The gradient of a gather is a scatter-add over ``idx``; for bf16/f16
    ``x`` it is accumulated in f32, as in `segment_sum`.
    """
    if _narrow_float(x.dtype):
        return _take_f32_grad(x, idx)
    return _take(x, idx)


def segment_sum(data, segment_ids, num_segments):
    """Sum ``data`` rows into ``num_segments`` buckets by ``segment_ids``.

    Out-of-range ids (e.g. the padding id ``num_segments``) are dropped.
    bf16/f16 data is accumulated in f32.
    """
    _expand_ids(segment_ids, data)
    return _sum(data, segment_ids, num_segments)


def segment_count(segment_ids, num_segments, dtype=jnp.float32):
    """Number of entries per segment (in-degree when ids are edge dsts)."""
    ones = jnp.ones(segment_ids.shape[0], dtype=dtype)
    return _sum(ones, segment_ids, num_segments)


def segment_mean(data, segment_ids, num_segments):
    """Mean of ``data`` rows per segment; empty segments yield 0."""
    _expand_ids(segment_ids, data)
    total = _sum(data, segment_ids, num_segments)
    count = segment_count(segment_ids, num_segments, dtype=data.dtype)
    count = jnp.maximum(count, 1)
    return total / count.reshape((num_segments,) + (1,) * (data.ndim - 1))


def segment_max(data, segment_ids, num_segments):
    """Max of ``data`` rows per segment; empty segments yield 0.

    The reference's C++ kernel tracks arg-max indices for the backward pass
    (gammagl/mpops/torch_ext/cuda/segment_max_cuda.cu:68-105); XLA derives the
    same subgradient automatically from the scatter-max.
    """
    _expand_ids(segment_ids, data)
    out = jax.ops.segment_max(data, segment_ids, num_segments=num_segments)
    # Empty segments come back as -inf; zero them like the reference does.
    return jnp.where(jnp.isneginf(out), 0.0, out) if jnp.issubdtype(
        data.dtype, jnp.floating) else out


def segment_min(data, segment_ids, num_segments):
    """Min of ``data`` rows per segment; empty segments yield 0."""
    _expand_ids(segment_ids, data)
    out = jax.ops.segment_min(data, segment_ids, num_segments=num_segments)
    return jnp.where(jnp.isposinf(out), 0.0, out) if jnp.issubdtype(
        data.dtype, jnp.floating) else out


# The reference distinguishes sorted `segment_*` from `unsorted_segment_*`
# (gammagl/mpops/torch.py); on XLA the same scatter handles both, so the
# unsorted names are aliases kept for API parity.
unsorted_segment_sum = segment_sum
unsorted_segment_mean = segment_mean
unsorted_segment_max = segment_max
unsorted_segment_min = segment_min
