"""HCHA (hypergraph convolution + attention) trainer.

Reference flow: examples/hcha/ in the reference repo (dataset -> model ->
Adam semi-supervised CE). The model is assembled inline from the conv layer
as the reference example does.

Usage: python examples/hcha/hcha_trainer.py --dataset cora
"""

import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", ".."))

from gammagl_tpu import nn
from gammagl_tpu.layers.conv import HypergraphConv
from examples.common import base_parser, run_simple_node_trainer, probe_num_classes


class Net(nn.Module):
    hidden_dim: int = 16
    num_class: int = 7
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, x, edge_index, train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        # star expansion: hyperedge j = neighborhood of node j, so the
        # incidence pairs are exactly the graph edges and num_edges is
        # static (= num_nodes)
        n = x.shape[0]
        x = nn.relu(HypergraphConv(out_channels=self.hidden_dim)(
            x, edge_index, num_nodes=n, num_edges=n))
        return HypergraphConv(out_channels=self.num_class)(
            drop(x), edge_index, num_nodes=n, num_edges=n)


def main(args):
    model = Net(hidden_dim=args.hidden_dim, num_class=probe_num_classes(args),
                drop_rate=args.drop_rate)
    return run_simple_node_trainer(model, args)


if __name__ == "__main__":
    main(base_parser(hidden_dim=16).parse_args())
