"""DropEdge (random edge dropping regularizer) trainer.

Reference flow: examples/dropedge/ in the reference repo (dataset -> model ->
Adam semi-supervised CE). The model is assembled inline from the conv layer
as the reference example does.

Usage: python examples/dropedge/dropedge_trainer.py --dataset cora
"""

import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", ".."))

from gammagl_tpu import nn
import jax
import jax.numpy as jnp
from gammagl_tpu.layers.conv import GCNConv
from examples.common import base_parser, run_simple_node_trainer, probe_num_classes


class Net(nn.Module):
    hidden_dim: int = 16
    num_class: int = 7
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, x, edge_index, train=False):
        if train:
            # mask half the edges by routing them out of range; the
            # segment ops drop out-of-range destinations exactly
            rng = self.make_rng("dropout")
            keep = jax.random.bernoulli(rng, 0.5, (edge_index.shape[1],))
            edge_index = jnp.where(keep[None, :], edge_index,
                                   x.shape[0] + 1)
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        h = nn.relu(GCNConv(self.hidden_dim)(x, edge_index,
                                             num_nodes=x.shape[0]))
        return GCNConv(self.num_class)(drop(h), edge_index,
                                       num_nodes=x.shape[0])


def main(args):
    model = Net(hidden_dim=args.hidden_dim, num_class=probe_num_classes(args),
                drop_rate=args.drop_rate)
    return run_simple_node_trainer(model, args)


if __name__ == "__main__":
    main(base_parser(hidden_dim=16).parse_args())
