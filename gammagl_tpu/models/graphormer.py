"""Graphormer model (Ying 2021) for graph-level prediction.

Reference: gammagl/models/graphormer.py -- centrality + spatial encodings,
stacked dense-attention layers, virtual-node-free mean readout.
"""

from gammagl_tpu import nn
import jax.numpy as jnp

from gammagl_tpu.layers.attention.graphormer import (
    CentralityEncoder, GraphormerLayer, SpatialEncoder)

__all__ = ["GraphormerModel"]


class GraphormerModel(nn.Module):
    hidden_dim: int = 80
    num_class: int = 1
    num_layers: int = 4
    num_heads: int = 8
    max_degree: int = 64
    max_dist: int = 5
    dropout_rate: float = 0.1

    @nn.compact
    def __call__(self, x, in_degree, out_degree, dist, mask=None,
                 train=False):
        """x: (N, F) one graph (or padded batch member); dist: (N, N)."""
        h = nn.Dense(self.hidden_dim)(x)
        h = CentralityEncoder(self.max_degree, self.hidden_dim)(
            h, in_degree, out_degree)
        bias = SpatialEncoder(self.max_dist, self.num_heads)(dist)
        for _ in range(self.num_layers):
            h = GraphormerLayer(self.hidden_dim, self.num_heads,
                                dropout_rate=self.dropout_rate)(
                h, attn_bias=bias, mask=mask, train=train)
        h = nn.LayerNorm()(h)
        if mask is not None:
            denom = jnp.maximum(mask.sum(), 1)
            pooled = (h * mask[:, None]).sum(0) / denom
        else:
            pooled = h.mean(0)
        return nn.Dense(self.num_class)(pooled)
