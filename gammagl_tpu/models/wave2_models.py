"""Wave-2 models: PNA, CompGCN, DGCNN (SortPool), HardGAT-free GaAN.

Reference: gammagl/models/{pna,compgcn,dgcnn,gaan}.py.
"""

from typing import Optional

from gammagl_tpu import nn
import jax.numpy as jnp

from gammagl_tpu.layers.conv import (CompConv, EdgeConv, GaANConv, PNAConv)
from gammagl_tpu.layers.pool import global_sort_pool

__all__ = ["PNAModel", "CompGCNModel", "DGCNNModel", "GaANModel"]


class PNAModel(nn.Module):
    hidden_dim: int = 64
    num_class: int = 7
    num_layers: int = 2
    drop_rate: float = 0.3

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        for _ in range(self.num_layers - 1):
            x = nn.relu(PNAConv(out_channels=self.hidden_dim)(
                x, edge_index, num_nodes))
            x = drop(x)
        return PNAConv(out_channels=self.num_class)(x, edge_index,
                                                    num_nodes)


class CompGCNModel(nn.Module):
    """Knowledge-graph encoder: learned relation embeddings threaded through
    CompConv layers (reference compgcn.py)."""

    num_relations: int
    hidden_dim: int = 64
    num_class: int = 4
    num_layers: int = 2
    op: str = "sub"

    @nn.compact
    def __call__(self, x, edge_index, edge_type, num_nodes=None):
        rel = self.param("rel_emb", nn.initializers.glorot_uniform(),
                         (self.num_relations, x.shape[-1]))
        for i in range(self.num_layers):
            dim = (self.hidden_dim if i < self.num_layers - 1
                   else self.num_class)
            x, rel = CompConv(out_channels=dim, op=self.op)(
                x, edge_index, edge_type, rel, num_nodes)
            if i < self.num_layers - 1:
                x = nn.relu(x)
        return x


class DGCNNModel(nn.Module):
    """EdgeConv stack + SortPool readout + 1D conv head for graph
    classification (reference dgcnn.py / SEAL usage)."""

    hidden_dim: int = 32
    num_class: int = 2
    num_layers: int = 3
    k: int = 30

    @nn.compact
    def __call__(self, x, edge_index, batch=None, num_graphs=None,
                 num_nodes=None):
        hs = []
        for _ in range(self.num_layers):
            x = jnp.tanh(EdgeConv(out_channels=self.hidden_dim)(
                x, edge_index, num_nodes))
            hs.append(x)
        # final 1-channel layer provides the sort key
        key_feat = jnp.tanh(EdgeConv(out_channels=1)(x, edge_index,
                                                     num_nodes))
        h = jnp.concatenate(hs + [key_feat], axis=-1)
        pooled = global_sort_pool(h, batch, self.k,
                                  num_graphs=num_graphs)  # (B, k*F)
        B = pooled.shape[0]
        F = h.shape[-1]
        seq = pooled.reshape(B, self.k, F)
        seq = nn.Conv(16, kernel_size=(3,), strides=(1,))(seq)
        seq = nn.relu(seq)
        seq = nn.max_pool(seq, window_shape=(2,), strides=(2,))
        seq = seq.reshape(B, -1)
        seq = nn.relu(nn.Dense(128)(seq))
        return nn.Dense(self.num_class)(seq)


class GaANModel(nn.Module):
    hidden_dim: int = 16
    num_class: int = 7
    heads: int = 4
    num_layers: int = 2

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        for _ in range(self.num_layers - 1):
            x = nn.relu(GaANConv(out_channels=self.hidden_dim,
                                 heads=self.heads)(x, edge_index,
                                                   num_nodes))
        return GaANConv(out_channels=self.num_class, heads=self.heads)(
            x, edge_index, num_nodes)
