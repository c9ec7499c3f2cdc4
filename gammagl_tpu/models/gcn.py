"""GCN model (reference: gammagl/models/gcn.py:6)."""

from gammagl_tpu import nn

from gammagl_tpu.layers.conv import GCNConv

__all__ = ["GCNModel"]


class GCNModel(nn.Module):
    """Two-layer GCN with ReLU + dropout (Kipf & Welling)."""

    hidden_dim: int = 16
    num_class: int = 7
    drop_rate: float = 0.5
    num_layers: int = 2
    norm: str = "both"
    dtype: object = None  # compute dtype (bf16 recipe); params stay f32

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None,
                 train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        for _ in range(self.num_layers - 1):
            x = GCNConv(self.hidden_dim, norm=self.norm, dtype=self.dtype)(
                x, edge_index, edge_weight, num_nodes)
            x = nn.relu(x)
            x = drop(x)
        return GCNConv(self.num_class, norm=self.norm, dtype=self.dtype)(
            x, edge_index, edge_weight, num_nodes)
