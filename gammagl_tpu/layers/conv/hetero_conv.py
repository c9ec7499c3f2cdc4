"""HeteroConv wrapper + HANConv + HGTConv + SimpleHGNConv.

Reference files: gammagl/layers/conv/hetero_wrapper.py:20 (per-edge-type conv
dict + group-aggregate :7-18), han_conv.py:31 (per-metapath GAT + semantic
attention :14), hgt_conv.py:8 (per-type Q/K/V + relation matrices + custom
propagate :135-156), simplehgn_conv.py (edge-type-aware attention).
"""

from typing import Any, Dict, Tuple

from gammagl_tpu import nn
import jax
import jax.numpy as jnp

from gammagl_tpu.layers.conv.message_passing import MessagePassing
from gammagl_tpu.ops import bspmm, segment_softmax
from gammagl_tpu.ops.segment import accum_dtype, gather_rows, segment_sum

__all__ = ["HeteroConv", "HANConv", "HGTConv", "SimpleHGNConv",
           "relation_attention"]


def relation_attention(q, k, v, edge_index, num_dst, rel_pri,
                       alpha_dropout=None):
    """HGT attention over one relation (reference hgt_conv.py:135-156):
    score_e = <q[dst_e], k[src_e]> * rel_pri / sqrt(D), a softmax over each
    destination's edges, then the alpha-weighted sum of v[src_e].

    q (N_dst, H, D); k, v (N_src, H, D); rel_pri (H,). `alpha_dropout`, if
    given, is applied to the (E, H) attention weights. Returns
    (N_dst, H, D)."""
    src, dst = edge_index[0], edge_index[1]
    k_e = gather_rows(k, src)
    v_e = gather_rows(v, src)
    q_e = gather_rows(q, dst)
    acc = accum_dtype(q.dtype)
    score = ((q_e.astype(acc) * k_e.astype(acc)).sum(-1) * rel_pri
             / (q.shape[-1] ** 0.5))  # (E, H)
    alpha = segment_softmax(score, dst, num_dst)
    if alpha_dropout is not None:
        alpha = alpha_dropout(alpha)
    return segment_sum(v_e * alpha[..., None], dst, num_dst)


def _group(values, aggr):
    """Combine per-edge-type outputs landing on one node type
    (reference hetero_wrapper.py:7-18)."""
    if len(values) == 1:
        return values[0]
    stacked = jnp.stack(values, axis=0)
    if aggr == "sum":
        return stacked.sum(0)
    if aggr == "mean":
        return stacked.mean(0)
    if aggr == "max":
        return stacked.max(0)
    if aggr == "cat":
        return jnp.concatenate(values, axis=-1)
    raise ValueError(f"unknown aggr {aggr!r}")


class HeteroConv(nn.Module):
    """Run one conv per edge type, aggregate per destination node type.

    `convs` maps (src, rel, dst) -> a conv module taking
    (x or (x_src, x_dst), edge_index, num_nodes).
    """

    convs: Dict[Tuple[str, str, str], Any]
    aggr: str = "sum"

    @nn.compact
    def __call__(self, x_dict, edge_index_dict, num_nodes_dict=None):
        out_lists = {}
        for et, conv in self.convs.items():
            if et not in edge_index_dict:
                continue
            src_t, _, dst_t = et
            n_dst = (num_nodes_dict[dst_t] if num_nodes_dict
                     else x_dict[dst_t].shape[0])
            x_in = (x_dict[src_t] if src_t == dst_t
                    else (x_dict[src_t], x_dict[dst_t]))
            out = conv(x_in, edge_index_dict[et], num_nodes=n_dst)
            out_lists.setdefault(dst_t, []).append(out)
        return {k: _group(v, self.aggr) for k, v in out_lists.items()}


class SemAttAggr(nn.Module):
    """Semantic attention over metapath outputs (reference han_conv.py:14)."""

    hidden_size: int

    @nn.compact
    def __call__(self, z):
        # z: (M, N, F) stacked per-metapath embeddings
        w = nn.Dense(self.hidden_size)(z)
        w = jnp.tanh(w)
        w = nn.Dense(1, use_bias=False)(w)
        beta = jax.nn.softmax(jnp.mean(w, axis=1), axis=0)  # (M, 1)
        return jnp.sum(beta[:, None, :] * z, axis=0)


class HANConv(nn.Module):
    """Heterogeneous graph attention (Wang 2019).

    Node-level GAT per edge type, semantic attention across types
    (reference han_conv.py:31).
    """

    out_channels: int
    metadata: Tuple
    heads: int = 1
    negative_slope: float = 0.2
    dropout_rate: float = 0.0

    @nn.compact
    def __call__(self, x_dict, edge_index_dict, num_nodes_dict=None,
                 train=False):
        from gammagl_tpu.layers.conv.gat_conv import GATConv

        out_lists = {nt: [] for nt in x_dict}
        for et in self.metadata[1]:
            if et not in edge_index_dict:
                continue
            src_t, _, dst_t = et
            n_dst = (num_nodes_dict[dst_t] if num_nodes_dict
                     else x_dict[dst_t].shape[0])
            gat = GATConv(out_channels=self.out_channels, heads=self.heads,
                          dropout_rate=self.dropout_rate, concat=True,
                          negative_slope=self.negative_slope,
                          name="gat__" + "__".join(et))
            out = gat(x_dict[src_t], edge_index_dict[et], num_nodes=n_dst,
                      train=train)
            out_lists[dst_t].append(nn.relu(out))
        sem = SemAttAggr(hidden_size=self.out_channels)
        out_dict = {}
        for nt, outs in out_lists.items():
            if outs:
                out_dict[nt] = sem(jnp.stack(outs, axis=0))
        return out_dict


class HGTConv(nn.Module):
    """Heterogeneous Graph Transformer (Hu 2020).

    Per-node-type K/Q/V projections, per-edge-type relation matrices inside
    the attention, per-type skip gates (reference hgt_conv.py:88-156).
    """

    out_channels: int
    metadata: Tuple
    heads: int = 1
    dropout_rate: float = 0.2
    dtype: object = None  # compute dtype (e.g. bf16); params stay f32

    @nn.compact
    def __call__(self, x_dict, edge_index_dict, num_nodes_dict=None,
                 train=False):
        H = self.heads
        D = self.out_channels // H
        from gammagl_tpu.utils.compute_dtype import resolve_dtype
        dtype = resolve_dtype(self.dtype)
        init = nn.initializers.glorot_uniform()
        ntypes, etypes = self.metadata

        k_dict, q_dict, v_dict = {}, {}, {}
        for nt in ntypes:
            if nt not in x_dict:
                continue
            x = x_dict[nt]
            k_dict[nt] = nn.Dense(H * D, kernel_init=init, dtype=dtype,
                                  name=f"k__{nt}")(x).reshape(-1, H, D)
            q_dict[nt] = nn.Dense(H * D, kernel_init=init, dtype=dtype,
                                  name=f"q__{nt}")(x).reshape(-1, H, D)
            v_dict[nt] = nn.Dense(H * D, kernel_init=init, dtype=dtype,
                                  name=f"v__{nt}")(x).reshape(-1, H, D)

        out_lists = {nt: [] for nt in x_dict}
        for et in etypes:
            if et not in edge_index_dict:
                continue
            src_t, rel, dst_t = et
            name = "__".join(et)
            a_rel = self.param(f"a_rel__{name}", init, (H, D, D))
            m_rel = self.param(f"m_rel__{name}", init, (H, D, D))
            rel_pri = self.param(f"pri__{name}", nn.initializers.ones, (H,))
            ei = edge_index_dict[et]
            n_dst = (num_nodes_dict[dst_t] if num_nodes_dict
                     else x_dict[dst_t].shape[0])
            if dtype is not None:
                a_rel = a_rel.astype(dtype)
                m_rel = m_rel.astype(dtype)
            k = jnp.einsum("nhd,hde->nhe", k_dict[src_t], a_rel)
            v = jnp.einsum("nhd,hde->nhe", v_dict[src_t], m_rel)
            drop = (nn.Dropout(self.dropout_rate, deterministic=not train)
                    if self.dropout_rate > 0 else None)
            out = relation_attention(q_dict[dst_t], k, v, ei, n_dst,
                                     rel_pri, alpha_dropout=drop)
            out_lists[dst_t].append(out.reshape(-1, H * D))

        out_dict = {}
        for nt, outs in out_lists.items():
            if not outs:
                continue
            agg = _group(outs, "sum")
            agg = nn.Dense(self.out_channels, kernel_init=init,
                           name=f"out__{nt}")(jax.nn.gelu(agg))
            skip = self.param(f"skip__{nt}", nn.initializers.ones, ())
            beta = jax.nn.sigmoid(skip)
            x = x_dict[nt]
            if x.shape[-1] == self.out_channels:
                agg = beta * agg + (1 - beta) * x
            out_dict[nt] = agg
        return out_dict


class SimpleHGNConv(MessagePassing):
    """Simple-HGN (Lv 2021): GAT attention plus a learned edge-type embedding
    term (reference simplehgn_conv.py). Operates on homogeneous tensors with
    an `edge_type` vector.
    """

    out_channels: int
    num_etypes: int
    heads: int = 1
    edge_dim: int = 32
    negative_slope: float = 0.2
    dropout_rate: float = 0.0
    residual: bool = True
    beta: float = 0.05

    @nn.compact
    def __call__(self, x, edge_index, edge_type, num_nodes=None,
                 alpha_prev=None, train=False):
        H, F = self.heads, self.out_channels
        if num_nodes is None:
            num_nodes = x.shape[0]
        init = nn.initializers.glorot_uniform()
        src, dst = edge_index[0], edge_index[1]

        h = nn.Dense(H * F, use_bias=False, kernel_init=init)(x)
        h = h.reshape(-1, H, F)
        e_emb = self.param("edge_emb", init,
                           (self.num_etypes, H * self.edge_dim))

        a_l = self.param("att_l", init, (1, H, F))
        a_r = self.param("att_r", init, (1, H, F))
        a_e = self.param("att_e", init, (1, H, self.edge_dim))
        e = jnp.take(e_emb, edge_type, axis=0).reshape(-1, H, self.edge_dim)
        h_src = jnp.take(h, jnp.minimum(src, h.shape[0] - 1), axis=0)
        h_dst = jnp.take(h, jnp.minimum(dst, h.shape[0] - 1), axis=0)
        logits = ((h_src * a_l).sum(-1) + (h_dst * a_r).sum(-1)
                  + (e * a_e).sum(-1))
        logits = nn.leaky_relu(logits, self.negative_slope)
        alpha = segment_softmax(logits, dst, num_nodes)
        if alpha_prev is not None:
            alpha = (1 - self.beta) * alpha + self.beta * alpha_prev
        if self.dropout_rate > 0:
            alpha = nn.Dropout(self.dropout_rate,
                               deterministic=not train)(alpha)
        out = bspmm(edge_index, alpha, h, num_nodes=num_nodes)
        out = out.reshape(-1, H * F)
        if self.residual:
            out = out + nn.Dense(H * F, use_bias=False, kernel_init=init)(x)
        return out, alpha
