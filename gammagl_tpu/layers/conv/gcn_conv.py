"""GCNConv (Kipf & Welling 2017).

Reference semantics: gammagl/layers/conv/gcn_conv.py:8 with norm modes
'left' | 'right' | 'both' | 'none' (:90-104): degree-normalized edge weights
computed from src/dst degrees, then a fused SpMM propagate.
"""

from gammagl_tpu import nn
import jax.numpy as jnp

from gammagl_tpu.layers.conv.message_passing import MessagePassing
from gammagl_tpu.ops.segment import segment_count

__all__ = ["GCNConv"]


class GCNConv(MessagePassing):
    out_channels: int
    norm: str = "both"
    add_bias: bool = True
    dtype: object = None  # compute dtype (e.g. jnp.bfloat16); params stay f32

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None):
        if self.norm not in ("left", "right", "both", "none"):
            raise ValueError(f"invalid norm {self.norm!r}")
        if num_nodes is None:
            num_nodes = x.shape[0]
        from gammagl_tpu.utils.compute_dtype import resolve_dtype
        dtype = resolve_dtype(self.dtype)
        x = nn.Dense(self.out_channels, use_bias=False, dtype=dtype,
                     kernel_init=nn.initializers.glorot_uniform())(x)
        src, dst = edge_index[0], edge_index[1]
        if edge_weight is None:
            edge_weight = jnp.ones(edge_index.shape[1], dtype=x.dtype)
        weights = edge_weight
        if self.norm in ("left", "both"):
            deg = segment_count(src, num_nodes, dtype=x.dtype)
            norm = jnp.where(deg > 0,
                             deg ** -0.5 if self.norm == "both" else 1.0 / deg,
                             0.0)
            weights = norm[src] * weights
        if self.norm in ("right", "both"):
            deg = segment_count(dst, num_nodes, dtype=x.dtype)
            norm = jnp.where(deg > 0,
                             deg ** -0.5 if self.norm == "both" else 1.0 / deg,
                             0.0)
            weights = weights * norm[dst]
        out = self.propagate(x, edge_index, edge_weight=weights,
                             num_nodes=num_nodes)
        if self.add_bias:
            bias = self.param("bias", nn.initializers.zeros,
                              (self.out_channels,))
            out = out + bias
        return out
