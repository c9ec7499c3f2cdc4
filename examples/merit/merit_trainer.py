"""MERIT (multi-scale siamese distillation) trainer: two-view contrastive pretraining + probe.

Reference flow: examples/merit/ (augment two views -> contrastive loss ->
linear probe on frozen embeddings). Synthetic SBM fallback when datasets
are unavailable.

Usage: python examples/merit/merit_trainer.py --dataset cora
"""

import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", ".."))

from gammagl_tpu import nn
import jax.numpy as jnp

from examples.common import base_parser, run_two_view_ssl
from gammagl_tpu.models import MERITModel


class Net(nn.Module):
    """Wrap MERIT's (z1, z2) forward into a loss-returning module so the
    shared two-view loop applies (BYOL loss, reference merit.py)."""

    hidden_dim: int = 128

    @nn.compact
    def __call__(self, x1, ei1, w1, x2=None, ei2=None, w2=None):
        m = MERITModel(hidden_dim=self.hidden_dim)
        if x2 is None:
            z1, _ = m(x1, ei1, w1, x1, ei1, w1)
            return z1
        z1, z2 = m(x1, ei1, w1, x2, ei2, w2)
        return 0.5 * (MERITModel.byol_loss(z1, jnp.asarray(z2))
                      + MERITModel.byol_loss(z2, jnp.asarray(z1)))


def main(args):
    model = Net(hidden_dim=args.hidden_dim)
    return run_two_view_ssl(model, args,
                            drop_rates=(0.2, 0.5, 0.2, 0.5),
                            embed_fn=lambda m, p, x, ei: m.apply(p, x, ei, None))


if __name__ == "__main__":
    parser = base_parser(hidden_dim=128, n_epoch=100, lr=0.0005)
    parser.add_argument('--drop_edge_rate_1', type=float, default=0.2)
    parser.add_argument('--drop_feature_rate_1', type=float, default=0.5)
    parser.add_argument('--drop_edge_rate_2', type=float, default=0.2)
    parser.add_argument('--drop_feature_rate_2', type=float, default=0.5)
    main(parser.parse_args())
