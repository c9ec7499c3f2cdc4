"""GCN full-batch trainer -- the reference's flagship example.

Reference flow: examples/gcn/gcn_trainer.py:52-141 (Planetoid -> add self
loops -> GCN -> Adam semi-supervised CE -> best-val checkpoint). Here the
whole train step is one jit region; with no dataset on disk it falls back to
a synthetic SBM graph so the script always runs.

Usage:
  python examples/gcn/gcn_trainer.py --dataset cora --lr 0.01 --n_epoch 200
"""

import argparse
import os.path as osp
import sys
import time

# allow running from a source checkout without installation
sys.path.insert(0, osp.join(osp.dirname(__file__), "..", ".."))

import numpy as np
import jax
import jax.numpy as jnp
import optax

from gammagl_tpu.models import GCNModel
from gammagl_tpu.utils import add_self_loops, mask_to_index
from gammagl_tpu.train import (TrainState, semi_supervised_loss, accuracy,
                               save_checkpoint, load_checkpoint)


def load_dataset(args):
    sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
    from common import load_node_dataset
    return load_node_dataset(args.dataset, args.dataset_path)


def main(args):
    graph, num_classes = load_dataset(args)
    ei, _ = add_self_loops(np.asarray(graph.edge_index),
                           num_nodes=graph.num_nodes)
    x = jnp.asarray(graph.x)
    y = jnp.asarray(np.asarray(graph.y))
    ei = jnp.asarray(ei)
    train_mask = jnp.asarray(np.asarray(graph.train_mask).reshape(-1))
    val_mask = jnp.asarray(np.asarray(graph.val_mask).reshape(-1))
    test_mask = jnp.asarray(np.asarray(graph.test_mask).reshape(-1))

    model = GCNModel(hidden_dim=args.hidden_dim, num_class=num_classes,
                     drop_rate=args.drop_rate)
    key = jax.random.PRNGKey(args.seed)
    params = model.init({"params": key, "dropout": key}, x, ei)
    tx = optax.chain(
        optax.add_decayed_weights(args.l2_coef),
        optax.adam(args.lr),
    )
    state = TrainState.create(params=params, tx=tx)

    # Data threaded through as jit ARGUMENTS (closing over device arrays
    # embeds them in the program as constants); epochs run in chunked lax.scan with the best-val
    # parameter snapshot tracked on device (replaces the reference's
    # save-weights-on-best, examples/gcn/gcn_trainer.py:110).
    sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
    from common import run_epoch_loop
    d = {"x": x, "edge_index": ei, "y": y, "train_mask": train_mask,
         "val_mask": val_mask, "test_mask": test_mask}

    def train_step(state, rng, d):
        def loss_fn(p):
            logits = model.apply(p, d["x"], d["edge_index"], train=True,
                                 rngs={"dropout": rng})
            return semi_supervised_loss(logits, d["y"], d["train_mask"])
        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads), loss

    def evaluate(state, d):
        logits = model.apply(state.params, d["x"], d["edge_index"])
        return (accuracy(logits, d["y"], d["val_mask"]),
                accuracy(logits, d["y"], d["test_mask"]))

    rng = jax.random.PRNGKey(args.seed + 1)
    t0 = time.time()
    state, best_val, best_test, best_params = run_epoch_loop(
        state, rng, d, train_step, evaluate, args.n_epoch, log_every=10,
        track_best_params=True)
    dt = time.time() - t0
    save_checkpoint(args.best_model_path, state.replace(params=best_params))
    print(f"done in {dt:.1f}s ({args.n_epoch / dt:.1f} epochs/s)")
    return best_test


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="cora")
    parser.add_argument("--dataset_path", type=str, default="data")
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--n_epoch", type=int, default=200)
    parser.add_argument("--hidden_dim", type=int, default=16)
    parser.add_argument("--drop_rate", type=float, default=0.5)
    parser.add_argument("--l2_coef", type=float, default=5e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--best_model_path", type=str,
                        default="/tmp/gcn_best.npz")
    main(parser.parse_args())
