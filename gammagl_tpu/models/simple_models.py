"""SGC, GIN, APPNP, GCNII, JKNet, MLP, ChebNet, MixHop, GPRGNN, FAGCN models.

Reference: gammagl/models/{sgc,gin,appnp,gcnii,jknet,mlp,chebnet,mixhop,
gprgnn,fagcn}.py.
"""

import math
from typing import Sequence

from gammagl_tpu import nn
import jax.numpy as jnp

from gammagl_tpu.layers.conv import (APPNPConv, ChebConv, FAGCNConv,
                                     GCNConv, GCNIIConv, GINConv, GPRConv,
                                     JumpingKnowledge, MixHopConv, SGConv)
from gammagl_tpu.layers.pool import global_sum_pool

__all__ = ["SGCModel", "GINModel", "APPNPModel", "GCNIIModel", "JKNet",
           "MLP", "ChebNetModel", "MixHopModel", "GPRGNNModel", "FAGCNModel"]


class MLP(nn.Module):
    """Plain MLP baseline (reference mlp.py)."""

    hidden_dim: Sequence[int] = (64,)
    num_class: int = 7
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, x, train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        for h in self.hidden_dim:
            x = nn.relu(nn.Dense(h)(x))
            x = drop(x)
        return nn.Dense(self.num_class)(x)


class SGCModel(nn.Module):
    num_class: int = 7
    itera_k: int = 2

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None,
                 train=False):
        return SGConv(self.num_class, itera_k=self.itera_k)(
            x, edge_index, edge_weight, num_nodes)


class GINModel(nn.Module):
    """GIN for graph classification (reference gin.py): stacked GINConv with
    per-layer MLPs + batchnorm, sum pooling, jumping-knowledge sum of layer
    scores."""

    hidden_dim: int = 64
    num_class: int = 2
    num_layers: int = 5
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, x, edge_index, batch=None, num_graphs=None,
                 num_nodes=None, train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        scores = []
        for i in range(self.num_layers):
            mlp = nn.Sequential([
                nn.Dense(self.hidden_dim), nn.relu,
                nn.Dense(self.hidden_dim), nn.relu,
            ])
            x = GINConv(apply_func=mlp)(x, edge_index, num_nodes=num_nodes)
            x = nn.LayerNorm()(x)
            pooled = global_sum_pool(x, batch, num_graphs)
            scores.append(drop(nn.Dense(self.num_class)(pooled)))
        return sum(scores)


class APPNPModel(nn.Module):
    hidden_dim: int = 64
    num_class: int = 7
    alpha: float = 0.1
    itera_k: int = 10
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None,
                 train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        x = drop(x)
        x = nn.relu(nn.Dense(self.hidden_dim)(x))
        x = drop(x)
        x = nn.Dense(self.num_class)(x)
        return APPNPConv(itera_k=self.itera_k, alpha=self.alpha)(
            x, edge_index, edge_weight, num_nodes, train=train)


class GCNIIModel(nn.Module):
    hidden_dim: int = 64
    num_class: int = 7
    num_layers: int = 64
    alpha: float = 0.1
    lambd: float = 0.5
    variant: bool = False
    drop_rate: float = 0.6

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None,
                 train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        x = drop(x)
        x = nn.relu(nn.Dense(self.hidden_dim)(x))
        x0 = x
        for layer in range(1, self.num_layers + 1):
            beta = math.log(self.lambd / layer + 1)
            x = drop(x)
            x = nn.relu(GCNIIConv(self.hidden_dim, beta=float(beta),
                                  alpha=self.alpha, variant=self.variant)(
                x, x0, edge_index, edge_weight, num_nodes))
        x = drop(x)
        return nn.Dense(self.num_class)(x)


class JKNet(nn.Module):
    """GCN backbone + jumping knowledge (reference jknet.py)."""

    hidden_dim: int = 16
    num_class: int = 7
    num_layers: int = 4
    mode: str = "max"
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None,
                 train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        xs = []
        for _ in range(self.num_layers):
            x = nn.relu(GCNConv(self.hidden_dim)(
                x, edge_index, edge_weight, num_nodes))
            x = drop(x)
            xs.append(x)
        x = JumpingKnowledge(mode=self.mode)(xs)
        return nn.Dense(self.num_class)(x)


class ChebNetModel(nn.Module):
    hidden_dim: int = 32
    num_class: int = 7
    K: int = 3
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None,
                 train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        x = nn.relu(ChebConv(self.hidden_dim, K=self.K)(
            x, edge_index, edge_weight, num_nodes))
        x = drop(x)
        return ChebConv(self.num_class, K=self.K)(
            x, edge_index, edge_weight, num_nodes)


class MixHopModel(nn.Module):
    hidden_dim: int = 60
    num_class: int = 7
    p: Sequence[int] = (0, 1, 2)
    num_layers: int = 2
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None,
                 train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        for _ in range(self.num_layers - 1):
            x = nn.relu(MixHopConv(self.hidden_dim // len(self.p),
                                   p=tuple(self.p))(
                x, edge_index, edge_weight, num_nodes))
            x = drop(x)
        return nn.Dense(self.num_class)(x)


class GPRGNNModel(nn.Module):
    hidden_dim: int = 64
    num_class: int = 7
    K: int = 10
    alpha: float = 0.1
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None,
                 train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        x = drop(x)
        x = nn.relu(nn.Dense(self.hidden_dim)(x))
        x = drop(x)
        x = nn.Dense(self.num_class)(x)
        return GPRConv(K=self.K, alpha=self.alpha)(
            x, edge_index, edge_weight, num_nodes)


class FAGCNModel(nn.Module):
    hidden_dim: int = 16
    num_class: int = 7
    num_layers: int = 2
    drop_rate: float = 0.4

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        x = drop(x)
        x = nn.relu(nn.Dense(self.hidden_dim)(x))
        x = drop(x)
        h0 = x
        eps = 0.3
        for _ in range(self.num_layers):
            x = eps * h0 + FAGCNConv(self.hidden_dim)(
                x, edge_index, num_nodes, train=train)
        return nn.Dense(self.num_class)(x)
