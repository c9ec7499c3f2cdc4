"""FusedGAT trainer: GAT over the reference's FusedGATConv protocol.

The reference's FusedGATConv wraps dgNN's fused CUDA kernels
(examples/fusedgat/). Here `FusedGATModel` runs GATConv, whose score,
edge softmax and weighted aggregation XLA fuses; the edges are put in
`FusedGATConv.to_graph_format` order once, before training.

Usage: python examples/fusedgat/fusedgat_trainer.py --dataset cora
"""

import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", ".."))

import jax
import jax.numpy as jnp
import optax

from examples.common import base_parser, device_graph, load_node_dataset
from gammagl_tpu.layers.conv import FusedGATConv
from gammagl_tpu.models import FusedGATModel
from gammagl_tpu.train import TrainState, accuracy, semi_supervised_loss


def main(args):
    g, num_classes = load_node_dataset(args.dataset, args.dataset_path)
    d = device_graph(g)
    x = d["x"]
    ei = jnp.asarray(FusedGATConv.to_graph_format(d["edge_index"],
                                                  g.num_nodes))
    model = FusedGATModel(hidden_dim=args.hidden_dim, heads=args.heads,
                          num_class=num_classes, drop_rate=0.0)
    key = jax.random.PRNGKey(args.seed)
    params = model.init(key, x, ei)
    state = TrainState.create(params=params, tx=optax.adam(args.lr))

    @jax.jit
    def step(state, x, ei, y, train_mask):
        loss, grads = jax.value_and_grad(
            lambda p: semi_supervised_loss(model.apply(p, x, ei),
                                           y, train_mask))(state.params)
        return state.apply_gradients(grads), loss

    @jax.jit
    def infer(state, x, ei):
        return model.apply(state.params, x, ei)

    for epoch in range(args.n_epoch):
        state, loss = step(state, x, ei, d["y"], d["train_mask"])
        if epoch % 20 == 0:
            acc = accuracy(infer(state, x, ei), d["y"], d["test_mask"])
            print(f"epoch {epoch:3d} loss {float(loss):.4f} "
                  f"test {float(acc):.4f}")
    acc = float(accuracy(infer(state, x, ei), d["y"], d["test_mask"]))
    print(f"final test acc {acc:.4f}")
    return acc


if __name__ == "__main__":
    parser = base_parser(hidden_dim=8, n_epoch=100, lr=0.005)
    parser.add_argument("--heads", type=int, default=8)
    main(parser.parse_args())
