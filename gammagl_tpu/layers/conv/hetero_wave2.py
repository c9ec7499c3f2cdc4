"""Hetero conv wave 2: HPN, ieHGCN, Hid (HiD-Net), RoheHAN.

Reference: gammagl/layers/conv/{hpn_conv.py, iehgcn_conv.py, hid_conv.py,
rohehan_conv.py}.
"""

from typing import Dict, Tuple

from gammagl_tpu import nn
import jax
import jax.numpy as jnp

from gammagl_tpu.layers.conv.message_passing import MessagePassing
from gammagl_tpu.layers.conv.simple_convs import APPNPConv
from gammagl_tpu.layers.conv.hetero_conv import SemAttAggr
from gammagl_tpu.ops import bspmm, segment_softmax
from gammagl_tpu.ops.segment import segment_count, segment_sum

__all__ = ["HPNConv", "ieHGCNConv", "HidConv", "RoheHANConv"]


class HPNConv(nn.Module):
    """Heterogeneous Graph Propagation (reference hpn_conv.py): APPNP
    propagation per edge type + semantic attention across types."""

    out_channels: int
    metadata: Tuple
    iter_K: int = 3
    alpha: float = 0.1
    drop_rate: float = 0.0

    @nn.compact
    def __call__(self, x_dict, edge_index_dict, num_nodes_dict=None,
                 train=False):
        out_lists = {nt: [] for nt in x_dict}
        for et in self.metadata[1]:
            if et not in edge_index_dict:
                continue
            src_t, _, dst_t = et
            n_dst = (num_nodes_dict[dst_t] if num_nodes_dict
                     else x_dict[dst_t].shape[0])
            h = nn.Dense(self.out_channels,
                         name="proj__" + "__".join(et))(x_dict[src_t])
            if src_t == dst_t:
                # metapath adjacency (the HPN setting): APPNP propagation
                h = APPNPConv(itera_k=self.iter_K, alpha=self.alpha)(
                    h, edge_index_dict[et], num_nodes=n_dst, train=train)
            else:
                # bipartite relation: single mean aggregation
                ei = edge_index_dict[et]
                msg = jnp.take(h, ei[0], axis=0, mode="clip")
                deg = segment_count(ei[1], n_dst, h.dtype)
                h = segment_sum(msg, ei[1], n_dst) / jnp.maximum(
                    deg, 1)[:, None]
            out_lists[dst_t].append(nn.relu(h))
        sem = SemAttAggr(hidden_size=self.out_channels)
        return {nt: sem(jnp.stack(v, 0)) for nt, v in out_lists.items()
                if v}


class ieHGCNConv(nn.Module):
    """ieHGCN (reference iehgcn_conv.py): object-level aggregation per edge
    type + type-level (query/key) attention at each destination type."""

    out_channels: int
    metadata: Tuple
    attn_channels: int = 32

    @nn.compact
    def __call__(self, x_dict, edge_index_dict, num_nodes_dict=None):
        init = nn.initializers.glorot_uniform()
        # self projection per node type
        self_h = {nt: nn.Dense(self.out_channels, kernel_init=init,
                               name=f"w_self__{nt}")(x)
                  for nt, x in x_dict.items()}
        # per-edge-type neighbor aggregation (mean) projected from src type
        agg = {nt: [] for nt in x_dict}
        keys = {nt: [] for nt in x_dict}
        for et in self.metadata[1]:
            if et not in edge_index_dict:
                continue
            src_t, _, dst_t = et
            n_dst = (num_nodes_dict[dst_t] if num_nodes_dict
                     else x_dict[dst_t].shape[0])
            ei = edge_index_dict[et]
            h = nn.Dense(self.out_channels, kernel_init=init,
                         name="w__" + "__".join(et))(x_dict[src_t])
            msg = jnp.take(h, ei[0], axis=0, mode="clip")
            deg = segment_count(ei[1], n_dst, h.dtype)
            nbr = segment_sum(msg, ei[1], n_dst) / jnp.maximum(
                deg, 1)[:, None]
            agg[dst_t].append(nbr)
            keys[dst_t].append("__".join(et))
        out = {}
        for nt, parts in agg.items():
            cands = [self_h[nt]] + parts  # self + each edge type
            q = nn.Dense(self.attn_channels, name=f"q__{nt}")(self_h[nt])
            scores = []
            for i, c in enumerate(cands):
                k = nn.Dense(self.attn_channels,
                             name=f"k__{nt}__{i}")(c)
                scores.append(jnp.sum(q * k, axis=-1))  # (N,)
            att = jax.nn.softmax(jnp.stack(scores, 0), axis=0)  # (C, N)
            stacked = jnp.stack(cands, 0)  # (C, N, F)
            out[nt] = jnp.sum(att[..., None] * stacked, axis=0)
        return out


class HidConv(MessagePassing):
    """HiD-Net high-order diffusion conv (reference hid_conv.py):
    x' = alpha*x0 + beta*A_hat x + gamma*(adaptive residual term)."""

    alpha: float = 0.1
    beta: float = 0.9
    gamma: float = 0.3
    sigma: float = 0.5

    @nn.compact
    def __call__(self, x, origin, edge_index, edge_weight=None,
                 num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        src, dst = edge_index[0], edge_index[1]
        if edge_weight is None:
            edge_weight = jnp.ones(edge_index.shape[1], x.dtype)
        deg = segment_count(dst, num_nodes, x.dtype)
        dis = jnp.where(deg > 0, deg ** -0.5, 0.0)
        w = dis[src] * edge_weight * dis[dst]
        ax = self.propagate(x, edge_index, edge_weight=w,
                            num_nodes=num_nodes)
        a2x = self.propagate(ax, edge_index, edge_weight=w,
                             num_nodes=num_nodes)
        # adaptive high-order residual (g gate per node)
        g = jax.nn.sigmoid(self.sigma * (ax - a2x))
        return (self.alpha * origin + self.beta * ax
                + self.gamma * g * (ax - a2x))


class RoheHANConv(nn.Module):
    """Robust HAN (reference rohehan_conv.py): HAN with attention-purification
    masks per edge type (pre-computed trust scores clip the attention)."""

    out_channels: int
    metadata: Tuple
    heads: int = 1
    negative_slope: float = 0.2
    drop_rate: float = 0.0

    @nn.compact
    def __call__(self, x_dict, edge_index_dict, num_nodes_dict=None,
                 trust_dict=None, train=False):
        H, F = self.heads, self.out_channels
        out_lists = {nt: [] for nt in x_dict}
        for et in self.metadata[1]:
            if et not in edge_index_dict:
                continue
            src_t, _, dst_t = et
            name = "__".join(et)
            ei = edge_index_dict[et]
            n_dst = (num_nodes_dict[dst_t] if num_nodes_dict
                     else x_dict[dst_t].shape[0])
            h = nn.Dense(H * F, use_bias=False, name=f"w__{name}")(
                x_dict[src_t]).reshape(-1, H, F)
            att = self.param(f"att__{name}",
                             nn.initializers.truncated_normal(0.02),
                             (1, H, 2 * F))
            feat = jnp.concatenate(
                [jnp.take(h, ei[0], axis=0, mode="clip"),
                 jnp.take(h, ei[1], axis=0, mode="clip")], axis=-1)
            e = nn.leaky_relu(jnp.sum(feat * att, -1), self.negative_slope)
            if trust_dict is not None and et in trust_dict:
                # purification: suppress untrusted edges before softmax
                e = jnp.where(trust_dict[et][:, None] > 0, e, -1e9)
            alpha = segment_softmax(e, ei[1], n_dst)
            out = bspmm(ei, alpha, h, num_nodes=n_dst).reshape(-1, H * F)
            out_lists[dst_t].append(nn.relu(out))
        sem = SemAttAggr(hidden_size=self.out_channels)
        return {nt: sem(jnp.stack(v, 0)) for nt, v in out_lists.items()
                if v}
