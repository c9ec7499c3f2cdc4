"""RGCNConv (Schlichtkrull 2018) -- relation-typed graph convolution.

Reference: gammagl/layers/conv/rgcn_conv.py:16 with basis decomposition
(:124-140) and block-diagonal decomposition. The reference loops relations
with dynamically-shaped masked edge sets; XLA needs static shapes, so this
implementation transforms features under every relation up front
(einsum -> (R, N, F_out)) and gathers per-edge by `edge_type * N + src` --
one fused gather + segment-sum regardless of relation count.
"""

from typing import Optional

from gammagl_tpu import nn
import jax.numpy as jnp

from gammagl_tpu.layers.conv.message_passing import MessagePassing
from gammagl_tpu.ops.segment import segment_sum

__all__ = ["RGCNConv"]


class RGCNConv(MessagePassing):
    in_channels: int
    out_channels: int
    num_relations: int
    num_bases: Optional[int] = None
    num_blocks: Optional[int] = None
    root_weight: bool = True
    add_bias: bool = True

    @nn.compact
    def __call__(self, x, edge_index, edge_type, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        src, dst = edge_index[0], edge_index[1]
        init = nn.initializers.truncated_normal(0.02)
        R, Fi, Fo = self.num_relations, self.in_channels, self.out_channels

        if self.num_bases is not None:
            basis = self.param("weight", init, (self.num_bases, Fi, Fo))
            base_att = self.param("base_att", init, (R, self.num_bases))
            weight = jnp.einsum("rb,bio->rio", base_att, basis)
            h_all = jnp.einsum("ni,rio->rno", x, weight)
        elif self.num_blocks is not None:
            B = self.num_blocks
            assert Fi % B == 0 and Fo % B == 0
            weight = self.param("weight", init, (R, B, Fi // B, Fo // B))
            xb = x.reshape(-1, B, Fi // B)
            h_all = jnp.einsum("nbi,rbio->rnbo", xb, weight).reshape(
                R, -1, Fo)
        else:
            weight = self.param("weight", init, (R, Fi, Fo))
            h_all = jnp.einsum("ni,rio->rno", x, weight)

        # per-edge message h_all[edge_type, src]: one flat gather keeps the
        # shape static for any relation count
        n_src = x.shape[0]
        flat = h_all.reshape(R * n_src, Fo)
        idx = edge_type * n_src + jnp.minimum(src, n_src - 1)
        msg = jnp.take(flat, jnp.minimum(idx, R * n_src - 1), axis=0)
        out = segment_sum(msg, dst, num_nodes)

        if self.root_weight:
            root = self.param("root", init, (Fi, Fo))
            out = out + x[:num_nodes] @ root
        if self.add_bias:
            out = out + self.param("bias", init, (Fo,))
        return out
