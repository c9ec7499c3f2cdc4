"""Wave-7 convs: DHN, HEAT (edge-enhanced attention), CoED (directional).

Reference: gammagl/layers/conv/{dhn_conv,heat_conv,coed_conv}.py. The HEAT
reference materializes dense N x N edge-feature tensors with Python loops
(heat_conv.py:91-128); here the same attention runs edge-wise with
`segment_softmax`, so cost is O(E) and the whole layer stays inside jit.
"""

from gammagl_tpu import nn
import jax.numpy as jnp

from gammagl_tpu.layers.conv.message_passing import MessagePassing
from gammagl_tpu.ops import segment_softmax
from gammagl_tpu.ops.segment import segment_sum

__all__ = ["DHNConv", "HEATConv", "CoEDConv"]


class DHNConv(nn.Module):
    """Distance-encoding heterogeneous network conv (reference
    dhn_conv.py:5-67).

    Input is a flat per-sample feature block
    ``[node | neigh1 (K x F) | neigh2 (K x K x F)]`` produced by the DHN
    minibatch builder; 2-hop neighborhoods are mean-aggregated, pushed
    through an MLP, then 1-hop aggregated with the center node. ``hidden``
    plays the role of the reference's ``2 * batch_size`` layer width
    (dhn_conv.py:14-18) without baking the batch size into the module.
    """

    num_fea: int
    num_neighbor: int
    hidden: int = 64

    @nn.compact
    def __call__(self, fea):
        K, F = self.num_neighbor, self.num_fea
        node = fea[:, :F]
        neigh1 = fea[:, F:F * (K + 1)].reshape(-1, K, F)
        neigh2 = fea[:, F * (K + 1):].reshape(-1, K, K, F)

        neigh2_agg = neigh2.mean(axis=2)  # aggregate 2-hop (E[msg])
        tmp = jnp.concatenate([neigh1, neigh2_agg], axis=2)  # (B, K, 2F)
        tmp = nn.elu(nn.Dense(self.hidden, name="lin1",
                              kernel_init=nn.initializers.xavier_uniform())(
            tmp))
        emb = jnp.concatenate([node, tmp.mean(axis=1)], axis=1)
        emb = nn.elu(nn.Dense(self.hidden, name="lin2",
                              kernel_init=nn.initializers.xavier_uniform())(
            emb))
        emb = nn.elu(nn.Dense(self.hidden, name="lin3",
                              kernel_init=nn.initializers.xavier_uniform())(
            emb))
        return emb


class HEATConv(nn.Module):
    """Heterogeneous edge-enhanced graph attention (Mo et al. 2021;
    reference heat_conv.py:7-137).

    Node features plus per-edge attribute/type embeddings drive the
    attention score; messages combine the neighbor embedding with the edge
    attribute embedding. The reference aggregates over each node's
    *outgoing* edges (out[src] += alpha * msg(dst), heat_conv.py:96-130);
    this implementation follows that convention.
    """

    node_emb_size: int = 64
    edge_attr_emb_size: int = 64
    edge_type_emb_size: int = 64
    out_channels: int = 128
    heads: int = 3
    concat: bool = True
    negative_slope: float = 0.2

    @nn.compact
    def __call__(self, x, edge_index, edge_attr, edge_type, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        xavier = nn.initializers.xavier_uniform()
        lrelu = lambda v: nn.leaky_relu(v, self.negative_slope)  # noqa: E731

        h = nn.Dense(self.node_emb_size, use_bias=False, kernel_init=xavier,
                     name="node_feat_emb")(x)
        e_attr = lrelu(nn.Dense(self.edge_attr_emb_size, use_bias=False,
                                kernel_init=xavier,
                                name="edge_attr_emb")(edge_attr))
        e_type = lrelu(nn.Dense(self.edge_type_emb_size, use_bias=False,
                                kernel_init=xavier, name="edge_type_emb")(
            edge_type.astype(h.dtype)))

        src, dst = edge_index[0], edge_index[1]
        h_src = jnp.take(h, src, axis=0, mode="clip")
        h_dst = jnp.take(h, dst, axis=0, mode="clip")
        score_in = jnp.concatenate([h_src, h_dst, e_attr, e_type], axis=-1)
        alpha = lrelu(nn.Dense(self.heads, use_bias=False,
                               kernel_init=xavier,
                               name="attention_layer")(score_in))  # (E, H)
        alpha = segment_softmax(alpha, src, num_nodes)

        msg_in = jnp.concatenate([e_attr, h_dst], axis=-1)
        msg = lrelu(nn.Dense(self.heads * self.out_channels, use_bias=False,
                             kernel_init=xavier, name="update_node_emb")(
            msg_in)).reshape(-1, self.heads, self.out_channels)
        out = segment_sum(msg * alpha[:, :, None], src, num_nodes)
        if self.concat:
            return out.reshape(num_nodes, -1)
        return out.mean(axis=1)


class CoEDConv(MessagePassing):
    """Directional conv from CoED-GNN (reference coed_conv.py:14-120):
    separate linear transforms for the forward (src->dst) and reverse
    (dst->src) aggregation channels, plus an optional self branch.

    ``edge_weight`` may be a `(w_fwd, w_rev)` tuple carrying learned
    directional weights (coed_conv.py:80-84).
    """

    out_channels: int
    self_feature_transform: bool = True
    add_bias: bool = True

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        if isinstance(edge_weight, (tuple, list)):
            w_fwd, w_rev = edge_weight
        else:
            w_fwd = w_rev = edge_weight
        src, dst = edge_index[0], edge_index[1]

        def gather_agg(take_from, scatter_to, w):
            msg = jnp.take(x, take_from, axis=0, mode="clip")
            if w is not None:
                msg = msg * w.reshape(-1, 1)
            return segment_sum(msg, scatter_to, num_nodes)

        agg_fwd = gather_agg(src, dst, w_fwd)
        agg_rev = gather_agg(dst, src, w_rev)
        xavier = nn.initializers.xavier_uniform()
        out_fwd = nn.Dense(self.out_channels, use_bias=self.add_bias,
                           kernel_init=xavier, name="lin_src_to_dst")(
            agg_fwd)
        out_rev = nn.Dense(self.out_channels, use_bias=self.add_bias,
                           kernel_init=xavier, name="lin_dst_to_src")(
            agg_rev)
        if self.self_feature_transform:
            out_self = nn.Dense(self.out_channels, use_bias=self.add_bias,
                                kernel_init=xavier, name="lin_self")(x)
            return out_fwd, out_rev, out_self
        return out_fwd, out_rev
