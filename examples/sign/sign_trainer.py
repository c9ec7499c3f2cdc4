"""SIGN trainer (reference: examples/sign flow + BASELINE papers100M
config): K-hop aggregation precomputed once, training is pure GEMMs --
the ideal accelerator inner loop and the scalable path for huge graphs.
"""

import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp
import optax

from common import base_parser, load_node_dataset
from gammagl_tpu.models import SIGNModel
from gammagl_tpu.transforms import SIGN
from gammagl_tpu.train import TrainState, accuracy, semi_supervised_loss


def main(args):
    graph, num_classes = load_node_dataset(args.dataset, args.dataset_path)
    graph = SIGN(K=args.K)(graph.numpy())
    xs = [jnp.asarray(graph.x)] + [jnp.asarray(graph[f"x{k}"])
                                   for k in range(1, args.K + 1)]
    y = jnp.asarray(np.asarray(graph.y))
    train_mask = jnp.asarray(np.asarray(graph.train_mask).reshape(
        graph.num_nodes, -1)[:, 0])
    test_mask = jnp.asarray(np.asarray(graph.test_mask))

    model = SIGNModel(num_class=num_classes, hidden_dim=args.hidden_dim,
                      K=args.K, drop_rate=args.drop_rate)
    key = jax.random.PRNGKey(args.seed)
    params = model.init({"params": key, "dropout": key}, xs)
    state = TrainState.create(params=params, tx=optax.adam(args.lr))

    # device data threaded as jit args (never close over device arrays)
    @jax.jit
    def step(state, rng, xs, y, train_mask):
        def loss_fn(p):
            logits = model.apply(p, xs, train=True, rngs={"dropout": rng})
            return semi_supervised_loss(logits, y, train_mask)
        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads), loss

    rng = jax.random.PRNGKey(args.seed + 1)
    for epoch in range(args.n_epoch):
        rng, k = jax.random.split(rng)
        state, loss = step(state, k, xs, y, train_mask)
    acc = accuracy(jax.jit(model.apply)(state.params, xs), y, test_mask)
    print(f"SIGN K={args.K} test acc {float(acc):.4f}")
    return float(acc)


if __name__ == "__main__":
    main(base_parser(hidden_dim=64, n_epoch=100, lr=0.005,
                     drop_rate=0.3, K=3).parse_args())
