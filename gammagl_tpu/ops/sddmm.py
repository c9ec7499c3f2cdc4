"""SDDMM: sampled dense-dense matmul -- per-edge scores from endpoint features.

The reference hides this inside each attention conv as gather + elementwise
(gammagl/layers/conv/gat_conv.py:100-112, hgt_conv.py:148-156); making it an
explicit primitive lets XLA fuse the two gathers with the contraction and
gives the attention convs one shared hot path.
"""

import jax.numpy as jnp

from gammagl_tpu.ops.segment import accum_dtype, gather_rows

__all__ = ["sddmm", "sddmm_dot"]


def sddmm(edge_index, x_src, x_dst, op: str = "dot"):
    """Per-edge combination of source / destination node features.

    op='dot' : (E,[H]) contraction over the last axis (attention logits)
    op='add' / 'mul' / 'sub' : (E,[H],F) elementwise combine
    """
    src, dst = edge_index[0], edge_index[1]
    a = gather_rows(x_src, src)
    b = gather_rows(x_dst, dst)
    if op == "dot":
        # bf16/f16 products are summed in f32, then cast back
        dtype = jnp.result_type(a, b)
        acc = accum_dtype(dtype)
        return jnp.sum(a.astype(acc) * b.astype(acc), axis=-1).astype(dtype)
    if op == "add":
        return a + b
    if op == "mul":
        return a * b
    if op == "sub":
        return a - b
    raise ValueError(f"unknown op {op!r}")


def sddmm_dot(edge_index, x_src, x_dst):
    """Edge dot products: out[e] = <x_src[src_e], x_dst[dst_e]>."""
    return sddmm(edge_index, x_src, x_dst, op="dot")
