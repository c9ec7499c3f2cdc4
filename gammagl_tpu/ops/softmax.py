"""Edge softmax -- the attention primitive behind GAT/HAN/HGT/etc.

Reference semantics: gammagl/utils/softmax.py:10 (max-shift, exp, segment-sum,
gather-div). Here it is one fused jit region: XLA fuses the gathers and
elementwise ops around the two scatters.

Padded edges (segment id == num_segments / out of range) receive score 0:
their exp contributes nothing to the denominator because the scatter drops
them, and the final gather of the denominator is clamped, yielding a finite
division whose result is discarded by downstream masked reductions.
"""

import jax.numpy as jnp

from gammagl_tpu.ops.segment import gather_rows, segment_max, segment_sum

__all__ = ["segment_softmax"]


def segment_softmax(data, segment_ids, num_segments):
    """Softmax over entries sharing a segment id (per-destination-node).

    Parameters
    ----------
    data : (E, ...) edge scores
    segment_ids : (E,) destination node per edge
    num_segments : static int, number of nodes
    """
    max_values = segment_max(data, segment_ids, num_segments)
    # Padded (out-of-range) ids gather a clamped row instead of erroring.
    shifted = data - gather_rows(max_values, segment_ids)
    exp = jnp.exp(shifted)
    # Zero the padded rows so they cannot pollute via the gather-clamp.
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    exp = jnp.where(valid.reshape((-1,) + (1,) * (data.ndim - 1)), exp, 0.0)
    denom = segment_sum(exp, segment_ids, num_segments)
    return exp / (gather_rows(denom, segment_ids) + 1e-16)
