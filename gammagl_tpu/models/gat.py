"""GAT / GATv2 models (reference: gammagl/models/{gat,gatv2}.py)."""

from gammagl_tpu import nn

from gammagl_tpu.layers.conv import GATConv, GATV2Conv

__all__ = ["GATModel", "GATV2Model"]


class GATModel(nn.Module):
    hidden_dim: int = 8
    num_class: int = 7
    heads: int = 8
    drop_rate: float = 0.6
    dtype: object = None

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        x = drop(x)
        x = GATConv(self.hidden_dim, heads=self.heads,
                    dropout_rate=self.drop_rate, dtype=self.dtype)(
            x, edge_index, num_nodes, train=train)
        x = nn.elu(x)
        x = drop(x)
        return GATConv(self.num_class, heads=1, concat=False,
                       dropout_rate=self.drop_rate, dtype=self.dtype)(
            x, edge_index, num_nodes, train=train)


class GATV2Model(nn.Module):
    hidden_dim: int = 8
    num_class: int = 7
    heads: int = 8
    drop_rate: float = 0.6

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        x = drop(x)
        x = GATV2Conv(self.hidden_dim, heads=self.heads,
                      dropout_rate=self.drop_rate)(
            x, edge_index, num_nodes, train=train)
        x = nn.elu(x)
        x = drop(x)
        return GATV2Conv(self.num_class, heads=1, concat=False,
                         dropout_rate=self.drop_rate)(
            x, edge_index, num_nodes, train=train)
