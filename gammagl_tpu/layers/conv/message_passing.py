"""MessagePassing: the gather -> message -> aggregate -> update protocol.

Reference: gammagl/layers/conv/message_passing.py:35-167. The protocol is kept
(message / aggregate / message_aggregate / update / propagate override
points); the runtime `Inspector` kwarg reflection is dropped -- JAX favors
explicit arguments, and jit makes reflection-free dispatch essentially free.

Fusion rule (reference message_passing.py:144-147): when a subclass does not
override `message`, `propagate` takes the fused SpMM path -- a single
gather-scale-reduce that XLA fuses end to end.
"""

from typing import Optional

from gammagl_tpu import nn

from gammagl_tpu.ops import (gather_rows, segment_max, segment_mean,
                             segment_sum, spmm)

__all__ = ["MessagePassing"]


class MessagePassing(nn.Module):
    """Base class for message-passing layers.

    Subclasses implement `__call__` and call `self.propagate(x, edge_index,
    ...)`; override `message` / `aggregate` / `update` to customize.
    """

    def message(self, x, edge_index, edge_weight=None):
        """Per-edge message: gather source features, optionally scale.

        Reference: message_passing.py:55-61.
        """
        msg = gather_rows(x, edge_index[0])
        if edge_weight is not None:
            msg = msg * edge_weight.reshape((-1,) + (1,) * (msg.ndim - 1))
        return msg

    def aggregate(self, msg, edge_index, num_nodes=None, aggr="sum"):
        """Scatter-reduce messages to destinations (message_passing.py:63-92)."""
        dst = edge_index[1]
        if aggr == "sum":
            return segment_sum(msg, dst, num_nodes)
        if aggr == "mean":
            return segment_mean(msg, dst, num_nodes)
        if aggr == "max":
            return segment_max(msg, dst, num_nodes)
        raise NotImplementedError(f"aggr {aggr!r} not supported")

    def message_aggregate(self, x, edge_index, edge_weight=None, aggr="sum",
                          num_nodes=None):
        """Fused path = SpMM (message_passing.py:94-107)."""
        return spmm(edge_index, edge_weight, x, num_nodes=num_nodes,
                    reduce=aggr)

    def update(self, x):
        return x

    def propagate(self, x, edge_index, aggr="sum", edge_weight=None,
                  num_nodes: Optional[int] = None, **kwargs):
        if num_nodes is None:
            num_nodes = x.shape[0]
        cls = type(self)
        fused = (cls.message is MessagePassing.message
                 and cls.aggregate is MessagePassing.aggregate)
        if fused:
            out = self.message_aggregate(x, edge_index,
                                         edge_weight=edge_weight, aggr=aggr,
                                         num_nodes=num_nodes)
        else:
            msg = self.message(x, edge_index, edge_weight=edge_weight,
                               **kwargs)
            out = self.aggregate(msg, edge_index, num_nodes=num_nodes,
                                 aggr=aggr)
        return self.update(out)
