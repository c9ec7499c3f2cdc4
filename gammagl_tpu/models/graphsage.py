"""GraphSAGE models (reference: gammagl/models/graphsage.py:7,35).

Full-graph variant takes the whole edge set; the sampled variant consumes a
list of per-layer bipartite adjacency blocks from the neighbor sampler
(reference GraphSAGE_Sample_Model forward over `adjs`).
"""

from typing import Sequence

from gammagl_tpu import nn

from gammagl_tpu.layers.conv import SAGEConv

__all__ = ["GraphSAGEModel", "GraphSAGESampleModel"]


class GraphSAGEModel(nn.Module):
    hidden_dim: int = 64
    num_class: int = 7
    num_layers: int = 2
    aggr: str = "mean"
    drop_rate: float = 0.5
    dtype: object = None

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        for _ in range(self.num_layers - 1):
            x = SAGEConv(self.hidden_dim, aggr=self.aggr,
                         dtype=self.dtype)(
                x, edge_index, num_nodes)
            x = nn.relu(x)
            x = drop(x)
        return SAGEConv(self.num_class, aggr=self.aggr,
                        dtype=self.dtype)(
            x, edge_index, num_nodes)


class GraphSAGESampleModel(nn.Module):
    """Minibatch GraphSAGE over sampled bipartite blocks.

    `adjs` is a sequence of (edge_index, size) pairs, outermost hop first;
    features shrink from sampled neighborhood to seed nodes layer by layer.
    """

    hidden_dim: int = 64
    num_class: int = 41
    num_layers: int = 2
    aggr: str = "mean"
    drop_rate: float = 0.5
    dtype: object = None

    @nn.compact
    def __call__(self, x, adjs: Sequence, train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        for i, (edge_index, size_dst) in enumerate(adjs):
            x_dst = x[:size_dst]
            dim = (self.hidden_dim if i < self.num_layers - 1
                   else self.num_class)
            x = SAGEConv(dim, aggr=self.aggr, dtype=self.dtype)(
                (x, x_dst), edge_index, num_nodes=size_dst)
            if i < self.num_layers - 1:
                x = nn.relu(x)
                x = drop(x)
        return x
