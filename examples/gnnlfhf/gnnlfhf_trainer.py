"""GNN-LF/HF (low/high-frequency unified filters) trainer.

Reference flow: examples/gnnlfhf/gnnlfhf_trainer.py (dataset -> model -> Adam
semi-supervised CE -> best-val test accuracy). The whole train step is
one jit region; synthetic SBM fallback keeps the script runnable
without downloads.

Usage: python examples/gnnlfhf/gnnlfhf_trainer.py --dataset cora --lr 0.01
"""

import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", ".."))

from examples.common import base_parser, run_simple_node_trainer, probe_num_classes
from gammagl_tpu.models import GNNLFHFModel


def main(args):
    model = GNNLFHFModel(hidden_dim=args.hidden_dim, num_class=probe_num_classes(args), variant=args.variant, K=10, drop_rate=args.drop_rate)
    return run_simple_node_trainer(model, args)


if __name__ == "__main__":
    args = base_parser(hidden_dim=64, variant="lf").parse_args()
    main(args)
