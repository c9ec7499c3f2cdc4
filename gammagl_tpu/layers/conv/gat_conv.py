"""GATConv / GATV2Conv (Velickovic 2018; Brody 2022).

Reference semantics: gammagl/layers/conv/gat_conv.py:7 (edge scores =
a . [Wx_i || Wx_j], LeakyReLU, per-destination segment softmax, multi-head
weighted aggregate = bspmm) and gatv2_conv.py (score applies `a` after the
nonlinearity over summed endpoint features).
"""

from gammagl_tpu import nn
import jax.numpy as jnp

from gammagl_tpu.layers.conv.message_passing import MessagePassing
from gammagl_tpu.ops import bspmm, gather_rows, segment_softmax

__all__ = ["GATConv", "GATV2Conv"]


def _scores(feat, att):
    """Edge scores <feat_e, att>, the products summed in f32 as in `sddmm`.

    The scores and their softmax stay in f32 (E x H values, small beside
    the E x H x F messages); the callers cast alpha to the features' dtype
    for the aggregation."""
    return jnp.sum(feat.astype(jnp.float32) * att, axis=-1)


class GATConv(MessagePassing):
    out_channels: int
    heads: int = 1
    concat: bool = True
    negative_slope: float = 0.2
    dropout_rate: float = 0.0
    add_bias: bool = True
    dtype: object = None  # compute dtype (e.g. bf16); params stay f32

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        H, F = self.heads, self.out_channels
        if num_nodes is None:
            num_nodes = x.shape[0]
        from gammagl_tpu.utils.compute_dtype import resolve_dtype
        dtype = resolve_dtype(self.dtype)
        w = self.param("w", nn.initializers.truncated_normal(0.02),
                       (x.shape[-1], H * F))
        if dtype is not None:
            x = x.astype(dtype)
            w = w.astype(dtype)
        x = (x @ w).reshape(-1, H, F)
        att = self.param("att", nn.initializers.truncated_normal(0.02),
                         (1, H, 2 * F))
        src, dst = edge_index[0], edge_index[1]
        feat = jnp.concatenate(
            [gather_rows(x, src), gather_rows(x, dst)], axis=-1)
        e = _scores(feat, att)  # (E, H)
        e = nn.leaky_relu(e, self.negative_slope)
        alpha = segment_softmax(e, dst, num_nodes).astype(x.dtype)
        if self.dropout_rate > 0:
            alpha = nn.Dropout(self.dropout_rate,
                               deterministic=not train)(alpha)
        out = bspmm(edge_index, alpha, x, num_nodes=num_nodes)
        if self.concat:
            out = out.reshape(-1, H * F)
        else:
            out = out.mean(axis=1)
        if self.add_bias:
            bias = self.param("bias",
                              nn.initializers.truncated_normal(0.02),
                              (H * F,) if self.concat else (F,))
            out = out + bias
        return out


class GATV2Conv(MessagePassing):
    """'How Attentive are GATs?' -- score = a . LeakyReLU(W_l x_i + W_r x_j).

    Reference: gammagl/layers/conv/gatv2_conv.py.
    """

    out_channels: int
    heads: int = 1
    concat: bool = True
    negative_slope: float = 0.2
    dropout_rate: float = 0.0
    add_bias: bool = True
    share_weights: bool = False
    dtype: object = None  # compute dtype (e.g. bf16); params stay f32

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        H, F = self.heads, self.out_channels
        if num_nodes is None:
            num_nodes = x.shape[0]
        from gammagl_tpu.utils.compute_dtype import resolve_dtype
        dtype = resolve_dtype(self.dtype)
        lin_l = nn.Dense(H * F, use_bias=False, dtype=dtype,
                         kernel_init=nn.initializers.glorot_uniform())
        lin_r = lin_l if self.share_weights else nn.Dense(
            H * F, use_bias=False, dtype=dtype,
            kernel_init=nn.initializers.glorot_uniform())
        att = self.param("att", nn.initializers.truncated_normal(0.02),
                         (1, H, F))
        x_l = lin_l(x).reshape(-1, H, F)
        x_r = lin_r(x).reshape(-1, H, F)
        src, dst = edge_index[0], edge_index[1]
        feat = gather_rows(x_l, src) + gather_rows(x_r, dst)
        feat = nn.leaky_relu(feat, self.negative_slope)
        e = _scores(feat, att)
        alpha = segment_softmax(e, dst, num_nodes).astype(x_l.dtype)
        if self.dropout_rate > 0:
            alpha = nn.Dropout(self.dropout_rate,
                               deterministic=not train)(alpha)
        out = bspmm(edge_index, alpha, x_l, num_nodes=num_nodes)
        if self.concat:
            out = out.reshape(-1, H * F)
        else:
            out = out.mean(axis=1)
        if self.add_bias:
            bias = self.param("bias", nn.initializers.zeros,
                              (H * F,) if self.concat else (F,))
            out = out + bias
        return out
