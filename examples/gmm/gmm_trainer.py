"""GMM / MoNet (gaussian mixture model conv) trainer.

Reference flow: examples/gmm/ in the reference repo (dataset -> model ->
Adam semi-supervised CE). The model is assembled inline from the conv layer
as the reference example does.

Usage: python examples/gmm/gmm_trainer.py --dataset cora
"""

import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", ".."))

from gammagl_tpu import nn
import jax.numpy as jnp
from gammagl_tpu.utils import degree
from gammagl_tpu.layers.conv import GMMConv
from examples.common import base_parser, run_simple_node_trainer, probe_num_classes


class Net(nn.Module):
    hidden_dim: int = 16
    num_class: int = 7
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, x, edge_index, train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        src, dst = edge_index[0], edge_index[1]
        deg = degree(dst, x.shape[0]).astype(jnp.float32)
        pseudo = jnp.stack([1.0 / jnp.sqrt(deg[src] + 1.0),
                            1.0 / jnp.sqrt(deg[dst] + 1.0)], axis=1)
        x = nn.relu(GMMConv(out_channels=self.hidden_dim, dim=2,
                            kernel_size=3)(x, edge_index, pseudo))
        return GMMConv(out_channels=self.num_class, dim=2,
                       kernel_size=3)(drop(x), edge_index, pseudo)


def main(args):
    model = Net(hidden_dim=args.hidden_dim, num_class=probe_num_classes(args),
                drop_rate=args.drop_rate)
    return run_simple_node_trainer(model, args)


if __name__ == "__main__":
    main(base_parser(hidden_dim=16).parse_args())
