"""EdgePrompt (learnable edge prompt tuning) trainer.

Reference flow: examples/edgeprompt/edgeprompt_trainer.py (dataset -> model -> Adam
semi-supervised CE -> best-val test accuracy). The whole train step is
one jit region; synthetic SBM fallback keeps the script runnable
without downloads.

Usage: python examples/edgeprompt/edgeprompt_trainer.py --dataset cora --lr 0.01
"""

import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", ".."))

from examples.common import base_parser, run_simple_node_trainer, probe_num_classes
from gammagl_tpu import nn

from gammagl_tpu.models import EdgePromptModel


class Net(nn.Module):
    hidden_dim: int = 16

    @nn.compact
    def __call__(self, x, edge_index, train=False):
        return EdgePromptModel(num_class=probe_num_classes(args), hidden_dim=self.hidden_dim,
                               num_prompts=4)(x, edge_index)


def main(args):
    model = Net(hidden_dim=args.hidden_dim)
    return run_simple_node_trainer(model, args)


if __name__ == "__main__":
    args = base_parser(hidden_dim=16).parse_args()
    main(args)
