"""DGI two-stage trainer (reference: examples/dgi/dgi_trainer.py):
self-supervised pretraining then a logistic-regression probe.
"""

import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp
import optax

from common import base_parser, device_graph, load_node_dataset
from gammagl_tpu.models import DGIModel, corrupt_features
from gammagl_tpu.train import TrainState, accuracy, semi_supervised_loss


def main(args):
    graph, num_classes = load_node_dataset(args.dataset, args.dataset_path)
    d = device_graph(graph)
    model = DGIModel(hidden_dim=args.hidden_dim)
    key = jax.random.PRNGKey(args.seed)
    xc = corrupt_features(key, d["x"])
    params = model.init(key, d["x"], d["edge_index"], xc)
    state = TrainState.create(params=params, tx=optax.adam(args.lr))

    # graph threaded as jit args (never close over device arrays); the
    # corruption + step runs as a chunked lax.scan (one host sync per chunk)
    @jax.jit
    def pretrain_chunk(state, rng, d):
        def body(carry, _):
            state, rng = carry
            rng, k = jax.random.split(rng)
            xc = corrupt_features(k, d["x"])
            loss, grads = jax.value_and_grad(
                lambda p: model.apply(p, d["x"], d["edge_index"], xc))(
                state.params)
            return (state.apply_gradients(grads), rng), loss
        (state, rng), losses = jax.lax.scan(body, (state, rng), None,
                                            length=20)
        return state, rng, losses

    rng = jax.random.PRNGKey(args.seed + 1)
    for epoch in range(0, args.n_epoch, 20):
        state, rng, losses = pretrain_chunk(state, rng, d)
        print(f"pretrain {epoch:4d} loss {float(losses[-1]):.4f}")

    # linear probe on frozen embeddings (emb passed as a jit arg)
    emb = model.apply(state.params, d["x"], d["edge_index"])
    emb = emb / (jnp.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
    w = jnp.zeros((emb.shape[1], num_classes))
    opt = optax.adam(1e-2)
    opt_state = opt.init(w)

    @jax.jit
    def probe_steps(w, opt_state, emb, y, train_mask):
        def body(carry, _):
            w, opt_state = carry
            loss, grads = jax.value_and_grad(
                lambda w: semi_supervised_loss(emb @ w, y, train_mask))(w)
            updates, opt_state = opt.update(grads, opt_state)
            return (optax.apply_updates(w, updates), opt_state), loss
        (w, opt_state), _ = jax.lax.scan(body, (w, opt_state), None,
                                         length=300)
        return w, opt_state

    w, opt_state = probe_steps(w, opt_state, emb, d["y"], d["train_mask"])
    acc = accuracy(emb @ w, d["y"], d["test_mask"])
    print(f"DGI probe test acc {float(acc):.4f}")
    return float(acc)


if __name__ == "__main__":
    main(base_parser(hidden_dim=256, n_epoch=100, lr=0.001).parse_args())
