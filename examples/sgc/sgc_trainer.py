"""SGC (simplified graph convolution) trainer.

Reference flow: examples/sgc/sgc_trainer.py (dataset -> model -> Adam
semi-supervised CE -> best-val test accuracy). The whole train step is
one jit region; synthetic SBM fallback keeps the script runnable
without downloads.

Usage: python examples/sgc/sgc_trainer.py --dataset cora --lr 0.2
"""

import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", ".."))

from examples.common import base_parser, run_simple_node_trainer, probe_num_classes
from gammagl_tpu.models import SGCModel


def main(args):
    model = SGCModel(num_class=probe_num_classes(args), itera_k=2)
    return run_simple_node_trainer(model, args)


if __name__ == "__main__":
    args = base_parser(hidden_dim=16, lr=0.2, l2_coef=5e-6).parse_args()
    main(args)
