"""DNA (dynamic neighborhood aggregation) trainer.

Reference flow: examples/dna/ in the reference repo (dataset -> model ->
Adam semi-supervised CE). The model is assembled inline from the conv layer
as the reference example does.

Usage: python examples/dna/dna_trainer.py --dataset cora
"""

import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", ".."))

from gammagl_tpu import nn
import jax.numpy as jnp
from gammagl_tpu.layers.conv import DNAConv
from examples.common import base_parser, run_simple_node_trainer, probe_num_classes


class Net(nn.Module):
    hidden_dim: int = 16
    num_class: int = 7
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, x, edge_index, train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        h = nn.relu(nn.Dense(self.hidden_dim)(drop(x)))
        hs = h[:, None]
        for _ in range(2):
            h = DNAConv(heads=1)(hs, edge_index)
            hs = jnp.concatenate([hs, h[:, None]], axis=1)
        return nn.Dense(self.num_class)(drop(hs[:, -1]))


def main(args):
    model = Net(hidden_dim=args.hidden_dim, num_class=probe_num_classes(args),
                drop_rate=args.drop_rate)
    return run_simple_node_trainer(model, args)


if __name__ == "__main__":
    main(base_parser(hidden_dim=16).parse_args())
