"""APPNP (personalized-PageRank propagation) trainer.

Reference flow: examples/appnp/appnp_trainer.py (dataset -> model -> Adam
semi-supervised CE -> best-val test accuracy). The whole train step is
one jit region; synthetic SBM fallback keeps the script runnable
without downloads.

Usage: python examples/appnp/appnp_trainer.py --dataset cora --lr 0.01
"""

import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", ".."))

from examples.common import base_parser, run_simple_node_trainer, probe_num_classes
from gammagl_tpu.models import APPNPModel


def main(args):
    model = APPNPModel(hidden_dim=args.hidden_dim, num_class=probe_num_classes(args), itera_k=10, alpha=0.1, drop_rate=args.drop_rate)
    return run_simple_node_trainer(model, args)


if __name__ == "__main__":
    args = base_parser(hidden_dim=64).parse_args()
    main(args)
