"""Heterogeneous models: RGCN, HAN, HGT, SimpleHGN.

Reference: gammagl/models/{rgcn,han,hgt,simplehgn}.py.
"""

from typing import Dict, Optional, Tuple

from gammagl_tpu import nn
import jax.numpy as jnp

from gammagl_tpu.layers.conv.rgcn_conv import RGCNConv
from gammagl_tpu.layers.conv.hetero_conv import (HANConv, HGTConv,
                                                 SimpleHGNConv)

__all__ = ["RGCNModel", "HANModel", "HGTModel", "SimpleHGNModel"]


class RGCNModel(nn.Module):
    in_channels: int
    hidden_channels: int
    num_class: int
    num_relations: int
    num_bases: Optional[int] = None
    num_layers: int = 2

    @nn.compact
    def __call__(self, x, edge_index, edge_type, num_nodes=None):
        x = RGCNConv(self.in_channels, self.hidden_channels,
                     self.num_relations, num_bases=self.num_bases)(
            x, edge_index, edge_type, num_nodes)
        x = nn.relu(x)
        return RGCNConv(self.hidden_channels, self.num_class,
                        self.num_relations, num_bases=self.num_bases)(
            x, edge_index, edge_type, num_nodes)


class HANModel(nn.Module):
    metadata: Tuple
    hidden_channels: int
    num_class: int
    target_ntype: str
    heads: int = 8
    drop_rate: float = 0.6

    @nn.compact
    def __call__(self, x_dict, edge_index_dict, num_nodes_dict=None,
                 train=False):
        out = HANConv(out_channels=self.hidden_channels,
                      metadata=self.metadata, heads=self.heads,
                      dropout_rate=self.drop_rate)(
            x_dict, edge_index_dict, num_nodes_dict, train=train)
        h = out[self.target_ntype]
        return nn.Dense(self.num_class)(h)


class HGTModel(nn.Module):
    metadata: Tuple
    hidden_channels: int
    num_class: int
    target_ntype: str
    heads: int = 4
    num_layers: int = 2
    dtype: object = None

    @nn.compact
    def __call__(self, x_dict, edge_index_dict, num_nodes_dict=None,
                 train=False):
        # project every type into the shared hidden space first
        h_dict = {nt: nn.relu(nn.Dense(self.hidden_channels,
                                       name=f"proj__{nt}")(x))
                  for nt, x in x_dict.items()}
        for i in range(self.num_layers):
            out = HGTConv(out_channels=self.hidden_channels,
                          metadata=self.metadata, heads=self.heads,
                          dtype=self.dtype, name=f"hgt_{i}")(
                h_dict, edge_index_dict, num_nodes_dict, train=train)
            h_dict = {**h_dict, **out}
        return nn.Dense(self.num_class)(h_dict[self.target_ntype])


class SimpleHGNModel(nn.Module):
    num_etypes: int
    hidden_channels: int
    num_class: int
    heads: int = 8
    num_layers: int = 2
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, x, edge_index, edge_type, num_nodes=None,
                 train=False):
        alpha = None
        for i in range(self.num_layers):
            conv = SimpleHGNConv(out_channels=self.hidden_channels,
                                 num_etypes=self.num_etypes,
                                 heads=self.heads,
                                 dropout_rate=self.drop_rate)
            x, alpha = conv(x, edge_index, edge_type, num_nodes,
                            alpha_prev=alpha, train=train)
            x = nn.elu(x)
        return nn.Dense(self.num_class)(x)
