"""Conv zoo wave 2: PNA, FiLM, EdgeConv, GMM, CompGCN, GaAN, DNA,
Hypergraph (HCHA).

Reference semantics per file in gammagl/layers/conv/: pna_conv.py,
film_conv.py, edge_conv.py, gmm_conv.py, comp_conv.py, gaan_conv.py,
dna_conv.py, hcha_conv.py.
"""

from typing import Optional, Sequence

from gammagl_tpu import nn
import jax
import jax.numpy as jnp

from gammagl_tpu.layers.conv.message_passing import MessagePassing
from gammagl_tpu.ops import bspmm, segment_softmax
from gammagl_tpu.ops.segment import (segment_count, segment_max,
                                     segment_mean, segment_min, segment_sum)

__all__ = ["PNAConv", "FILMConv", "EdgeConv", "GMMConv", "CompConv",
           "GaANConv", "DNAConv", "HypergraphConv"]


class PNAConv(MessagePassing):
    """Principal Neighbourhood Aggregation (Corso 2020; reference
    pna_conv.py): {mean,max,min,std} aggregators x {identity,amplification,
    attenuation} degree scalers."""

    out_channels: int
    aggregators: Sequence[str] = ("mean", "max", "min", "std")
    scalers: Sequence[str] = ("identity", "amplification", "attenuation")
    avg_deg_log: float = 1.0

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        src, dst = edge_index[0], edge_index[1]
        msg = jnp.take(x, src, axis=0, mode="clip")
        outs = []
        mean = segment_mean(msg, dst, num_nodes)
        for a in self.aggregators:
            if a == "mean":
                outs.append(mean)
            elif a == "max":
                outs.append(segment_max(msg, dst, num_nodes))
            elif a == "min":
                outs.append(segment_min(msg, dst, num_nodes))
            elif a == "std":
                sq = segment_mean(msg ** 2, dst, num_nodes)
                outs.append(jnp.sqrt(jnp.maximum(sq - mean ** 2, 0) + 1e-5))
            elif a == "sum":
                outs.append(segment_sum(msg, dst, num_nodes))
            else:
                raise ValueError(a)
        h = jnp.concatenate(outs, axis=-1)
        deg = segment_count(dst, num_nodes, x.dtype)
        logd = jnp.log(deg + 1)[:, None]
        scaled = []
        for s in self.scalers:
            if s == "identity":
                scaled.append(h)
            elif s == "amplification":
                scaled.append(h * (logd / self.avg_deg_log))
            elif s == "attenuation":
                scaled.append(h * (self.avg_deg_log / jnp.maximum(
                    logd, 1e-5)))
            else:
                raise ValueError(s)
        h = jnp.concatenate(scaled, axis=-1)
        return nn.Dense(self.out_channels)(
            jnp.concatenate([x[:num_nodes], h], axis=-1))


class FILMConv(MessagePassing):
    """GNN-FiLM (Brockschmidt 2020; reference film_conv.py): messages
    feature-wise modulated by the destination node."""

    out_channels: int
    num_relations: int = 1
    act: str = "relu"

    @nn.compact
    def __call__(self, x, edge_index, edge_type=None, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        src, dst = edge_index[0], edge_index[1]
        out = nn.Dense(self.out_channels, use_bias=False)(x[:num_nodes])
        film_self = nn.Dense(2 * self.out_channels)(x[:num_nodes])
        g, b = jnp.split(film_self, 2, axis=-1)
        out = nn.relu(g * out + b)
        for r in range(self.num_relations):
            w = nn.Dense(self.out_channels, use_bias=False)
            film = nn.Dense(2 * self.out_channels)
            h = w(x)
            gb = film(x)  # computed at destinations
            gamma, beta = jnp.split(gb, 2, axis=-1)
            msg = (jnp.take(gamma, dst, axis=0, mode="clip")
                   * jnp.take(h, src, axis=0, mode="clip")
                   + jnp.take(beta, dst, axis=0, mode="clip"))
            msg = nn.relu(msg)
            if edge_type is not None and self.num_relations > 1:
                msg = msg * (edge_type == r)[:, None]
            out = out + segment_mean(msg, dst, num_nodes)
        return out


class EdgeConv(MessagePassing):
    """Dynamic-graph EdgeConv (Wang 2019; reference edge_conv.py):
    max_j MLP([x_i || x_j - x_i])."""

    out_channels: int

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        src, dst = edge_index[0], edge_index[1]
        x_j = jnp.take(x, src, axis=0, mode="clip")
        x_i = jnp.take(x, dst, axis=0, mode="clip")
        msg = nn.Sequential([
            nn.Dense(self.out_channels), nn.relu,
            nn.Dense(self.out_channels),
        ])(jnp.concatenate([x_i, x_j - x_i], axis=-1))
        return segment_max(msg, dst, num_nodes)


class GMMConv(MessagePassing):
    """Gaussian mixture model conv / MoNet (Monti 2017; reference
    gmm_conv.py): per-edge pseudo-coordinates weighted by K gaussians."""

    out_channels: int
    dim: int = 2
    kernel_size: int = 3

    @nn.compact
    def __call__(self, x, edge_index, pseudo, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        K = self.kernel_size
        src, dst = edge_index[0], edge_index[1]
        mu = self.param("mu", nn.initializers.normal(0.1), (K, self.dim))
        sigma = self.param("sigma", nn.initializers.ones, (K, self.dim))
        diff = pseudo[:, None, :] - mu[None]  # (E, K, dim)
        w = jnp.exp(-0.5 * jnp.sum((diff / (sigma[None] + 1e-8)) ** 2,
                                   axis=-1))  # (E, K)
        h = nn.Dense(K * self.out_channels, use_bias=False)(x)
        h = h.reshape(-1, K, self.out_channels)
        msg = jnp.take(h, src, axis=0, mode="clip") * w[..., None]
        out = segment_sum(msg.sum(axis=1), dst, num_nodes)
        return out


class CompConv(MessagePassing):
    """CompGCN conv (Vashishth 2020; reference comp_conv.py): entity-relation
    composition (sub | mult) with per-direction weights."""

    out_channels: int
    op: str = "sub"

    @nn.compact
    def __call__(self, x, edge_index, edge_type, rel_emb, num_nodes=None):
        """rel_emb: (num_relations, F) relation embeddings (learned by the
        caller model so they can be shared across layers)."""
        if num_nodes is None:
            num_nodes = x.shape[0]
        src, dst = edge_index[0], edge_index[1]
        r = jnp.take(rel_emb, edge_type, axis=0)
        h = jnp.take(x, src, axis=0, mode="clip")
        if self.op == "sub":
            comp = h - r
        elif self.op == "mult":
            comp = h * r
        else:
            raise ValueError(self.op)
        msg = nn.Dense(self.out_channels, use_bias=False)(comp)
        out = segment_mean(msg, dst, num_nodes)
        out = out + nn.Dense(self.out_channels, use_bias=False)(
            x[:num_nodes])
        rel_out = nn.Dense(self.out_channels, use_bias=False)(rel_emb)
        return out, rel_out


class GaANConv(MessagePassing):
    """Gated attention networks (Zhang 2018; reference gaan_conv.py):
    multi-head GAT with per-node per-head gates from pooled neighbors."""

    out_channels: int
    heads: int = 4

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        H, F = self.heads, self.out_channels
        src, dst = edge_index[0], edge_index[1]
        h = nn.Dense(H * F, use_bias=False)(x).reshape(-1, H, F)
        att = self.param("att", nn.initializers.truncated_normal(0.02),
                         (1, H, 2 * F))
        feat = jnp.concatenate(
            [jnp.take(h, src, axis=0, mode="clip"),
             jnp.take(h, dst, axis=0, mode="clip")], axis=-1)
        e = nn.leaky_relu(jnp.sum(feat * att, axis=-1), 0.2)
        alpha = segment_softmax(e, dst, num_nodes)
        agg = bspmm(edge_index, alpha, h, num_nodes=num_nodes)  # (N, H, F)
        # gates from max+mean pooled neighbor features
        msg = jnp.take(x, src, axis=0, mode="clip")
        pool_max = segment_max(msg, dst, num_nodes)
        pool_mean = segment_mean(msg, dst, num_nodes)
        gate = nn.Dense(H)(jnp.concatenate(
            [x[:num_nodes], pool_max, pool_mean], axis=-1))
        gate = jax.nn.sigmoid(gate)[..., None]  # (N, H, 1)
        out = (agg * gate).reshape(-1, H * F)
        return nn.Dense(self.out_channels)(
            jnp.concatenate([x[:num_nodes], out], axis=-1))


class DNAConv(MessagePassing):
    """Dynamic neighborhood aggregation (Fey 2019; reference dna_conv.py):
    grouped attention of the current layer's query against all previous
    layer representations of neighbors."""

    heads: int = 1

    @nn.compact
    def __call__(self, x_all, edge_index, num_nodes=None):
        """x_all: (N, L, F) stack of representations from previous layers."""
        if num_nodes is None:
            num_nodes = x_all.shape[0]
        N, L, F = x_all.shape
        H = self.heads
        D = F // H
        src, dst = edge_index[0], edge_index[1]
        q = nn.Dense(F, use_bias=False)(x_all[:, -1])  # (N, F)
        k = nn.Dense(F, use_bias=False)(x_all)         # (N, L, F)
        v = nn.Dense(F, use_bias=False)(x_all)
        q_e = jnp.take(q, dst, axis=0, mode="clip").reshape(-1, H, 1, D)
        k_e = jnp.take(k, src, axis=0, mode="clip").reshape(-1, L, H, D)
        v_e = jnp.take(v, src, axis=0, mode="clip").reshape(-1, L, H, D)
        k_e = jnp.swapaxes(k_e, 1, 2)  # (E, H, L, D)
        v_e = jnp.swapaxes(v_e, 1, 2)
        attn = jax.nn.softmax(
            jnp.sum(q_e * k_e, -1) / (D ** 0.5), axis=-1)  # (E, H, L)
        msg = jnp.sum(attn[..., None] * v_e, axis=2)  # (E, H, D)
        out = segment_mean(msg.reshape(-1, F), dst, num_nodes)
        return out


class HypergraphConv(MessagePassing):
    """Hypergraph conv with optional attention (Bai 2021; reference
    hcha_conv.py). `hyperedge_index` is (2, nnz): (node, hyperedge)
    incidence pairs; propagation is X' = D^-1 H W B^-1 H^T X."""

    out_channels: int
    use_attention: bool = False
    heads: int = 1

    @nn.compact
    def __call__(self, x, hyperedge_index, hyperedge_weight=None,
                 num_nodes=None, num_edges=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        if num_edges is None:
            num_edges = int(hyperedge_index[1].max()) + 1
        node, he = hyperedge_index[0], hyperedge_index[1]
        h = nn.Dense(self.out_channels, use_bias=False)(x)
        w = (hyperedge_weight if hyperedge_weight is not None
             else jnp.ones(num_edges, x.dtype))
        # B^-1 H^T x : mean of member nodes per hyperedge
        d_e = segment_count(he, num_edges, x.dtype)
        edge_feat = segment_sum(jnp.take(h, node, axis=0, mode="clip"),
                                he, num_edges)
        edge_feat = edge_feat / jnp.maximum(d_e, 1)[:, None]
        edge_feat = edge_feat * w[:, None]
        # D^-1 H (...) : mean of incident hyperedges per node
        d_v = segment_count(node, num_nodes, x.dtype)
        out = segment_sum(jnp.take(edge_feat, he, axis=0, mode="clip"),
                          node, num_nodes)
        out = out / jnp.maximum(d_v, 1)[:, None]
        return out
