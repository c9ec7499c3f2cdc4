"""SAGEConv (Hamilton 2017).

Reference: gammagl/layers/conv/sage_conv.py -- W1 x_i + W2 mean_{j in N(i)} x_j,
with 'mean' | 'gcn' | 'pool' | 'max' aggregators and bipartite (src, dst)
feature pairs for sampled minibatches.
"""

from gammagl_tpu import nn
import jax.numpy as jnp

from gammagl_tpu.layers.conv.message_passing import MessagePassing
from gammagl_tpu.ops.segment import segment_count

__all__ = ["SAGEConv"]


class SAGEConv(MessagePassing):
    out_channels: int
    aggr: str = "mean"
    add_bias: bool = True
    dtype: object = None  # compute dtype (e.g. bf16); params stay f32

    @nn.compact
    def __call__(self, feat, edge_index, num_nodes=None):
        if isinstance(feat, tuple):
            src_feat, dst_feat = feat
        else:
            src_feat = dst_feat = feat
        if num_nodes is None:
            num_nodes = dst_feat.shape[0]
        from gammagl_tpu.utils.compute_dtype import resolve_dtype
        dtype = resolve_dtype(self.dtype)
        he = nn.initializers.he_normal()
        fc_neigh = nn.Dense(self.out_channels, use_bias=False,
                            dtype=dtype, kernel_init=he)
        if self.aggr == "mean":
            out = self.propagate(fc_neigh(src_feat), edge_index,
                                 num_nodes=num_nodes, aggr="mean")
        elif self.aggr == "gcn":
            # symmetric-normalized sum, no separate self transform
            src, dst = edge_index[0], edge_index[1]
            h = fc_neigh(src_feat)
            deg_src = segment_count(src, src_feat.shape[0], h.dtype)
            deg_dst = segment_count(dst, num_nodes, h.dtype)
            w = (jnp.where(deg_src > 0, deg_src ** -0.5, 0.0)[src]
                 * jnp.where(deg_dst > 0, deg_dst ** -0.5, 0.0)[dst])
            out = self.propagate(h, edge_index, edge_weight=w,
                                 num_nodes=num_nodes)
        elif self.aggr in ("pool", "max"):
            h = nn.relu(nn.Dense(src_feat.shape[-1], use_bias=False,
                                 dtype=dtype,
                                 kernel_init=he)(src_feat))
            out = self.propagate(h, edge_index, num_nodes=num_nodes,
                                 aggr="max")
            out = fc_neigh(out)
        else:
            raise ValueError(f"unknown aggr {self.aggr!r}")
        if self.aggr != "gcn":
            out = out + nn.Dense(self.out_channels, use_bias=False,
                                 dtype=dtype,
                                 kernel_init=he)(dst_feat)
        if self.add_bias:
            out = out + self.param("bias", nn.initializers.zeros,
                                   (self.out_channels,))
        return out
