"""CIT-GNN trainer: Cluster Information Transfer for structure-shift
robustness.

Reference flow: examples/citgnn/citgnn_trainer.py + utils.py — train a
2-layer GCN on the clean graph with mincut cluster regularizers over the
first layer's features (loss = 0.55*CE + 0.25*mincut + 0.2*ortho,
reference citgnn_trainer.py SemiSpvzLoss), then TEST on the
structure-shifted adjacency ``datasets/<name>_add_<ss>.npz`` (real
Planetoid edges + 50%/75% random additions, shipped in the reference
tree). The reference's CITModule.DSU feature transfer is computed but its
output is discarded by the loss (`assignment_matrics, _ = forward(...)`);
we therefore implement exactly the loss the reference optimizes.

Here mincut/ortho are computed SPARSELY from the edge list
(gammagl_tpu/layers/pool/mincut.py) — no N x N adjacency in HBM, unlike
the reference's ``adj_matrix.toarray()``.

Data: with ``--real-structure`` (default auto), the trainer uses the REAL
Planetoid adjacencies shipped in the reference tree — train structure from
examples/gcil/dataset/<name>/0.01_1_1.npz (1%-perturbed clean graph),
test structure from examples/citgnn/datasets/<name>_add_<ss>.npz. Features
are random and labels come from spectral clustering of the train
structure (no Planetoid feature/label files exist offline), so accuracies
are NOT comparable to the readme table — they measure structure-shift
robustness on the real graph topology. Falls back to a synthetic SBM
end to end when neither source is staged.
"""

import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", ".."))

import numpy as np
import jax
import jax.numpy as jnp
import optax

from examples.common import (base_parser, load_node_dataset,
                             load_sparse_npz, run_epoch_loop,
                             structure_node_data)
from gammagl_tpu.layers.pool import sparse_mincut_losses
from gammagl_tpu.models import GCNModel
from gammagl_tpu.train import TrainState, accuracy, semi_supervised_loss
from gammagl_tpu.utils import add_self_loops, calc_gcn_norm

from gammagl_tpu import nn

REF_GCIL = "/root/reference/examples/gcil/dataset"
REF_CITGNN = "/root/reference/examples/citgnn/datasets"


def _real_structure(name, ss, seed, num_classes=7):
    train_src = osp.join(REF_GCIL, name, "0.01_1_1.npz")
    test_src = osp.join(REF_CITGNN, f"{name}_add_{ss}.npz")
    if not osp.exists(test_src):
        return None
    if not osp.exists(train_src):
        train_src = osp.join(REF_CITGNN, f"{name}_add_0.5.npz")
        test_src = osp.join(REF_CITGNN, f"{name}_add_0.75.npz")
    ei_tr, n = load_sparse_npz(train_src)
    ei_te, n2 = load_sparse_npz(test_src)
    assert n == n2, (n, n2)
    x, y, train_mask, val_mask, test_mask = structure_node_data(
        ei_tr, n, num_classes, seed)
    return dict(x=x, y=y, ei_train=ei_tr, ei_test=ei_te, n=n,
                train_mask=train_mask, val_mask=val_mask,
                test_mask=test_mask, num_classes=num_classes,
                source=(train_src, test_src))


class AssignmentMLP(nn.Module):
    """Cluster-assignment head (reference utils.py AssignmentMatricsMLP);
    returns LOGITS — sparse_mincut_losses applies the softmax."""
    num_clusters: int

    @nn.compact
    def __call__(self, h):
        return nn.Dense(self.num_clusters)(h)


def main(args):
    real = None
    if args.real_structure:
        try:
            real = _real_structure(args.dataset, args.ss, args.seed)
        except Exception as e:
            print(f"[warn] real structure unavailable ({e})")
    if real is not None:
        x, y = real["x"], real["y"]
        n, num_classes = real["n"], real["num_classes"]
        ei_tr, ei_te = real["ei_train"], real["ei_test"]
        masks = (real["train_mask"], real["val_mask"], real["test_mask"])
        print(f"real structure: train {real['source'][0]} "
              f"({ei_tr.shape[1]} edges) test {real['source'][1]} "
              f"({ei_te.shape[1]} edges)")
    else:
        g, num_classes = load_node_dataset(args.dataset, args.dataset_path)
        x, y, n = np.asarray(g.x), np.asarray(g.y), g.num_nodes
        ei_tr = np.asarray(g.edge_index)
        # synthetic shift: add 50% random edges (the _add_<ss> protocol)
        rng = np.random.default_rng(args.seed)
        extra = rng.integers(0, n,
                             (2, int(ei_tr.shape[1] * float(args.ss))))
        ei_te = np.concatenate([ei_tr, extra], axis=1)
        masks = (np.asarray(g.train_mask), np.asarray(g.val_mask),
                 np.asarray(g.test_mask))

    ei_tr, _ = add_self_loops(ei_tr, num_nodes=n)
    ei_te, _ = add_self_loops(ei_te, num_nodes=n)
    w_tr = calc_gcn_norm(ei_tr, n)
    w_te = calc_gcn_norm(ei_te, n)

    model = GCNModel(hidden_dim=args.hidden_dim, num_class=num_classes,
                     drop_rate=args.drop_rate)
    head = AssignmentMLP(args.clusters)

    d = {"x": jnp.asarray(x), "y": jnp.asarray(y),
         "ei_tr": jnp.asarray(ei_tr), "w_tr": jnp.asarray(w_tr),
         "ei_te": jnp.asarray(ei_te), "w_te": jnp.asarray(w_te),
         "train_mask": jnp.asarray(masks[0].reshape(len(masks[0]), -1)[:, 0]),
         "val_mask": jnp.asarray(masks[1].reshape(len(masks[1]), -1)[:, 0]),
         "test_mask": jnp.asarray(masks[2])}

    key = jax.random.PRNGKey(args.seed)
    params = model.init({"params": key, "dropout": key}, d["x"], d["ei_tr"],
                        d["w_tr"])
    # intermediate features = first conv's output (reference SemiSpvzLoss)
    def first_layer(p, x, ei, w, rng=None, train=False):
        _, inter = model.apply(
            p, x, ei, w, train=train,
            rngs=None if rng is None else {"dropout": rng},
            capture_intermediates=lambda mdl, name: name == "__call__")
        convs = [v for k, v in inter["intermediates"].items()
                 if k.startswith("GCNConv")]
        return nn.relu(convs[0]["__call__"][0])

    h0 = first_layer(params, d["x"], d["ei_tr"], d["w_tr"])
    head_params = head.init(key, h0)
    all_params = {"gcn": params, "head": head_params}

    tx = optax.chain(optax.add_decayed_weights(args.l2_coef),
                     optax.adam(args.lr))
    state = TrainState.create(params=all_params, tx=tx)

    def train_step(state, rng, d):
        def loss_fn(p):
            logits = model.apply(p["gcn"], d["x"], d["ei_tr"], d["w_tr"],
                                 train=True, rngs={"dropout": rng})
            ce = semi_supervised_loss(logits, d["y"], d["train_mask"])
            h = first_layer(p["gcn"], d["x"], d["ei_tr"], d["w_tr"],
                            rng=rng, train=True)
            s_logits = head.apply(p["head"], h)
            mc, ortho = sparse_mincut_losses(s_logits, d["ei_tr"],
                                             h.shape[0])
            return 0.55 * ce + 0.25 * mc + 0.2 * ortho
        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads), loss

    def evaluate(state, d):
        # val on the clean graph, test on the SHIFTED adjacency
        # (reference test() loads <name>_add_<ss>.npz)
        logits_tr = model.apply(state.params["gcn"], d["x"], d["ei_tr"],
                                d["w_tr"])
        logits_te = model.apply(state.params["gcn"], d["x"], d["ei_te"],
                                d["w_te"])
        return (accuracy(logits_tr, d["y"], d["val_mask"]),
                accuracy(logits_te, d["y"], d["test_mask"]))

    rng = jax.random.PRNGKey(args.seed + 1)
    _, _, best_test = run_epoch_loop(state, rng, d, train_step, evaluate,
                                     args.n_epoch)
    return best_test


if __name__ == "__main__":
    p = base_parser(hidden_dim=16, n_epoch=200, lr=0.005)
    p.add_argument("--clusters", type=int, default=100)
    p.add_argument("--ss", type=str, default="0.5",
                   help="structure-shift ratio of the test adjacency")
    p.add_argument("--real_structure", type=int, default=1)
    main(p.parse_args())
