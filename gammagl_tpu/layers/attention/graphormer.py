"""Graphormer: dense attention with structural encodings.

Reference: gammagl/layers/attention/{graphormer_layer.py:8,46,61,
centrality_encoder.py:14, spatial_encoder.py:5, edge_encoder.py:10} and
gammagl/utils/shortest_path.py. This is the reference's only dense-attention
path -- dense matmuls and no scatter.
"""

from typing import Optional

from gammagl_tpu import nn
import jax
import jax.numpy as jnp

__all__ = ["CentralityEncoder", "SpatialEncoder", "EdgeEncoder",
           "GraphormerLayer"]


class CentralityEncoder(nn.Module):
    """Add learned in/out-degree embeddings to node features
    (reference centrality_encoder.py:14)."""

    max_degree: int
    embedding_dim: int

    @nn.compact
    def __call__(self, x, in_degree, out_degree):
        z_in = nn.Embed(self.max_degree + 1, self.embedding_dim)(
            jnp.clip(in_degree, 0, self.max_degree).astype(jnp.int32))
        z_out = nn.Embed(self.max_degree + 1, self.embedding_dim)(
            jnp.clip(out_degree, 0, self.max_degree).astype(jnp.int32))
        return x + z_in + z_out


class SpatialEncoder(nn.Module):
    """Shortest-path-distance attention bias
    (reference spatial_encoder.py:5). dist = -1 (unreachable) maps to the
    last bucket."""

    max_dist: int
    num_heads: int

    @nn.compact
    def __call__(self, dist):
        # dist: (N, N) int; bucket to [0, max_dist]; -1 -> max_dist + 1
        d = jnp.where(dist < 0, self.max_dist + 1,
                      jnp.clip(dist, 0, self.max_dist))
        table = nn.Embed(self.max_dist + 2, self.num_heads)
        return table(d.astype(jnp.int32))  # (N, N, H)


class EdgeEncoder(nn.Module):
    """Average edge-feature bias along shortest paths, simplified to the
    direct-edge variant (reference edge_encoder.py:10)."""

    num_heads: int

    @nn.compact
    def __call__(self, edge_attr_dense):
        # edge_attr_dense: (N, N, F)
        return nn.Dense(self.num_heads, use_bias=False)(edge_attr_dense)


class GraphormerLayer(nn.Module):
    """Pre-LN multi-head self-attention + FFN with additive attention bias
    (reference graphormer_layer.py:46,61)."""

    hidden_dim: int
    num_heads: int
    ffn_dim: int = None
    dropout_rate: float = 0.1

    @nn.compact
    def __call__(self, x, attn_bias=None, mask=None, train=False):
        H = self.num_heads
        D = self.hidden_dim // H
        ffn_dim = self.ffn_dim or 4 * self.hidden_dim
        drop = nn.Dropout(self.dropout_rate, deterministic=not train)

        h = nn.LayerNorm()(x)
        q = nn.Dense(H * D, use_bias=False)(h).reshape(-1, H, D)
        k = nn.Dense(H * D, use_bias=False)(h).reshape(-1, H, D)
        v = nn.Dense(H * D, use_bias=False)(h).reshape(-1, H, D)
        scores = jnp.einsum("nhd,mhd->hnm", q, k) / (D ** 0.5)
        if attn_bias is not None:
            scores = scores + jnp.transpose(attn_bias, (2, 0, 1))
        if mask is not None:
            scores = jnp.where(mask[None, None, :], scores, -1e9)
        attn = jax.nn.softmax(scores, axis=-1)
        attn = drop(attn)
        out = jnp.einsum("hnm,mhd->nhd", attn, v).reshape(-1, H * D)
        x = x + drop(nn.Dense(self.hidden_dim)(out))

        h = nn.LayerNorm()(x)
        h = nn.Dense(ffn_dim)(h)
        h = nn.gelu(h)
        h = drop(h)
        x = x + drop(nn.Dense(self.hidden_dim)(h))
        return x
