"""MGNNI (multiscale implicit GNN, fixed-point equilibrium) trainer.

Reference flow: examples/mgnni/mgnni_trainer.py (dataset -> model -> Adam
semi-supervised CE -> best-val test accuracy). The whole train step is
one jit region; synthetic SBM fallback keeps the script runnable
without downloads.

Usage: python examples/mgnni/mgnni_trainer.py --dataset cora --lr 0.01
"""

import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", ".."))

from examples.common import base_parser, run_simple_node_trainer, probe_num_classes
from gammagl_tpu.models import MGNNIModel


def main(args):
    model = MGNNIModel(num_class=probe_num_classes(args), hidden_dim=args.hidden_dim, scales=(1, 2), iters=8)
    return run_simple_node_trainer(model, args)


if __name__ == "__main__":
    args = base_parser(hidden_dim=32).parse_args()
    main(args)
