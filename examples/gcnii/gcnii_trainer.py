"""GCNII (initial residual + identity mapping) trainer.

Reference flow: examples/gcnii/gcnii_trainer.py (dataset -> model -> Adam
semi-supervised CE -> best-val test accuracy). The whole train step is
one jit region; synthetic SBM fallback keeps the script runnable
without downloads.

Usage: python examples/gcnii/gcnii_trainer.py --dataset cora --lr 0.01
"""

import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", ".."))

from examples.common import base_parser, run_simple_node_trainer, probe_num_classes
from gammagl_tpu.models import GCNIIModel


def main(args):
    model = GCNIIModel(hidden_dim=args.hidden_dim, num_class=probe_num_classes(args), num_layers=8, drop_rate=args.drop_rate)
    return run_simple_node_trainer(model, args)


if __name__ == "__main__":
    args = base_parser(hidden_dim=64).parse_args()
    main(args)
