"""Shared example-trainer utilities: dataset loading with synthetic
fallback, argparse defaults, train loop helpers."""

import argparse
import os
import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp


_DS_CACHE = {}


def load_node_dataset(name, path="data"):
    """Planetoid-style node-classification graph; synthetic SBM fallback
    when downloads are unavailable. Cached per (name, path) so trainers
    can probe num_classes before building the model without re-reading."""
    key = (name, path)
    if key in _DS_CACHE:
        return _DS_CACHE[key]
    _DS_CACHE[key] = _load_node_dataset_uncached(name, path)
    return _DS_CACHE[key]


def probe_num_classes(args):
    """Number of classes of the dataset the runner will load — for
    trainers that must size their output head before calling
    run_simple_node_trainer (cora 7 / citeseer 6 / pubmed 3 / synthetic
    fallback 7)."""
    return load_node_dataset(args.dataset, args.dataset_path)[1]


def _load_node_dataset_uncached(name, path="data"):
    if name in ("cora", "citeseer", "pubmed"):
        try:
            from gammagl_tpu.data.download import network_available
            from gammagl_tpu.datasets import Planetoid
            have_raw = osp.exists(osp.join(path, name, "raw"))
            if not (have_raw or network_available()):
                raise OSError("no network (fast probe) and no raw files")
            ds = Planetoid(root=path, name=name)
            return ds[0], ds.num_classes
        except Exception as e:
            print(f"[warn] {name} unavailable ({e}); trying "
                  "real-structure fallback")
        g = _load_real_structure(name)
        if g is not None:
            return g, int(np.asarray(g.y).max()) + 1
    from gammagl_tpu.datasets import synthetic_community_graph
    n, c, f = 1000, 7, 128
    if os.environ.get("GGL_REAL_SHAPES"):
        # real-shape smoke: pad the synthetic
        # fallback to the TRUE dataset dims so shape-dependent compile
        # bugs (feature-width tiling, class-count heads) surface for
        # every trainer, not just the on-chip flagships
        n, f, c = _REAL_DIMS.get(name, (n, f, c))
    g = synthetic_community_graph(n, c, f, avg_degree=8, seed=0)
    return g, c


# REAL Planetoid adjacencies the reference ships in-tree (true topology:
# cora nnz 13264 = 2*5278 + 2708 self-loops; pubmed 108365 = 2*44324 +
# 19717 — exact matches to the published graphs. citeseer only exists as
# the citgnn +50%-edges robustness variant, still real power-law
# structure). Features/labels are structure-derived (no feature files
# exist offline), so accuracy is NOT comparable to readme tables — the
# parity harness records these as "real-structure" without a verdict.
_STRUCT_ADJ = {
    "cora": "/root/reference/examples/gcil/dataset/cora/0.01_1_1.npz",
    "citeseer": ("/root/reference/examples/citgnn/datasets/"
                 "citeseer_add_0.5.npz"),
    "pubmed": "/root/reference/examples/gcil/dataset/pubmed/0.01_1_1.npz",
}
_STRUCT_CLASSES = {"cora": 7, "citeseer": 6, "pubmed": 3}


def _load_real_structure(name):
    """Graph on a REAL in-tree Planetoid adjacency with structure-derived
    node data (labels = spectral clusters, features = smoothed noise;
    `structure_node_data`). Synthetic SBM graphs measurably flatter the
    implementation (partition balance: 2.00x padded-edge inflation vs
    1.04x on real topology), so real structure is the default fallback;
    set GGL_SYNTHETIC=1 to force the old SBM graphs. The derived arrays
    are cached under data/<name>/struct_cache_*.npz (the pubmed eigsh
    costs seconds per process)."""
    if os.environ.get("GGL_SYNTHETIC") or name not in _STRUCT_ADJ:
        return None
    adj = _STRUCT_ADJ[name]
    if not osp.exists(adj):
        return None
    from gammagl_tpu.data import Graph
    c = _STRUCT_CLASSES[name]
    f = (_REAL_DIMS[name][1]
         if os.environ.get("GGL_REAL_SHAPES") else 128)
    ei, n = load_sparse_npz(adj)
    cache = osp.join("data", name, f"struct_cache_f{f}.npz")
    try:
        d = np.load(cache)
        x, y = d["x"], d["y"]
        tm, vm, sm = d["train_mask"], d["val_mask"], d["test_mask"]
    except Exception:
        x, y, tm, vm, sm = structure_node_data(ei, n, num_classes=c,
                                               feat_dim=f)
        try:
            os.makedirs(osp.dirname(cache), exist_ok=True)
            np.savez(cache, x=x, y=y, train_mask=tm, val_mask=vm,
                     test_mask=sm)
        except OSError:
            pass
    g = Graph(x=x, edge_index=ei)
    g.y = y.astype(np.int64)
    g.train_mask, g.val_mask, g.test_mask = tm, vm, sm
    g.data_kind = "real-structure"
    return g


# true (num_nodes, feat_dim, num_classes) per dataset, for GGL_REAL_SHAPES
_REAL_DIMS = {
    "cora": (2708, 1433, 7),
    "citeseer": (3327, 3703, 6),
    "pubmed": (19717, 500, 3),
    "reddit": (60_000, 602, 41),     # node count capped for CPU smoke
    "arxiv": (169_343, 128, 40),
    "ogbn-arxiv": (169_343, 128, 40),
}


def load_sparse_npz(path):
    """COO ('row'/'col') or CSR ('indptr'/'indices') scipy-format .npz ->
    (edge_index, num_nodes). The reference ships real Planetoid
    adjacencies in this format (examples/gcil/dataset/,
    examples/citgnn/datasets/)."""
    d = np.load(path, allow_pickle=True)
    n = int(d["shape"][0])
    if "row" in d:
        ei = np.stack([d["row"], d["col"]]).astype(np.int64)
    else:
        indptr, indices = d["indptr"], d["indices"]
        row = np.repeat(np.arange(n), np.diff(indptr))
        ei = np.stack([row, indices.astype(np.int64)])
    return ei, n


def structure_node_data(ei, n, num_classes=7, seed=0, feat_dim=128):
    """Node data derived purely from a REAL adjacency when no feature/
    label files exist offline: labels = spectral clustering of the
    (symmetrized) graph, features = one smoothing step of a random
    signal over it, split = Planetoid-style (20/class train, 500 val,
    1000 test). Returns (x, y, train_mask, val_mask, test_mask)."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import eigsh
    from sklearn.cluster import KMeans
    a = sp.coo_matrix((np.ones(ei.shape[1]), (ei[0], ei[1])),
                      shape=(n, n)).tocsr()
    a = ((a + a.T) > 0).astype(np.float64)
    d = np.asarray(a.sum(1)).ravel()
    dinv = 1.0 / np.sqrt(np.maximum(d, 1))
    # top eigenvectors of the normalized adjacency == bottom of the
    # Laplacian, without the shift-invert solve (singular on graphs
    # with isolated components)
    _, vec = eigsh(sp.diags(dinv) @ a @ sp.diags(dinv), k=num_classes,
                   which="LA")
    y = KMeans(num_classes, n_init=4,
               random_state=seed).fit_predict(vec)
    rng = np.random.default_rng(seed)
    x = np.asarray((a @ rng.normal(size=(n, feat_dim)))
                   / np.maximum(d, 1)[:, None]).astype(np.float32)
    perm = rng.permutation(n)
    train_mask = np.zeros(n, bool)
    for c in range(num_classes):
        train_mask[perm[y[perm] == c][:20]] = True
    rest = perm[~train_mask[perm]]
    val_mask = np.zeros(n, bool)
    val_mask[rest[:500]] = True
    test_mask = np.zeros(n, bool)
    test_mask[rest[500:1500]] = True
    return x, y, train_mask, val_mask, test_mask


def binary_auc(scores, labels):
    """ROC-AUC via the rank statistic (no sklearn needed in the hot
    path): P(score_pos > score_neg) with tie correction."""
    scores = np.asarray(scores, np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(bool)
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    # average ranks over ties
    sorted_s = scores[order]
    i = 0
    while i < len(sorted_s):
        j = i
        while j + 1 < len(sorted_s) and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j + 2) / 2.0
        i = j + 1
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def base_parser(**overrides):
    """Every trainer starts here: also turns on the compile cache."""
    from gammagl_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    parser = argparse.ArgumentParser()
    defaults = {
        "dataset": "cora", "dataset_path": "data", "lr": 0.01,
        "n_epoch": 200, "hidden_dim": 16, "drop_rate": 0.5,
        "l2_coef": 5e-4, "seed": 0,
    }
    defaults.update(overrides)
    for k, v in defaults.items():
        parser.add_argument(f"--{k}", type=type(v), default=v)
    return parser


def device_graph(g):
    """Move the standard fields to device with self-loops added."""
    from gammagl_tpu.utils import add_self_loops
    ei, _ = add_self_loops(np.asarray(g.edge_index), num_nodes=g.num_nodes)
    return {
        "x": jnp.asarray(g.x),
        "edge_index": jnp.asarray(ei),
        "y": jnp.asarray(np.asarray(g.y)),
        "train_mask": jnp.asarray(np.asarray(g.train_mask).reshape(
            np.asarray(g.train_mask).shape[0], -1)[:, 0]),
        "val_mask": jnp.asarray(np.asarray(g.val_mask).reshape(
            np.asarray(g.val_mask).shape[0], -1)[:, 0]),
        "test_mask": jnp.asarray(np.asarray(g.test_mask)),
    }


def run_epoch_loop(state, rng, d, step_fn, eval_fn, n_epoch,
                   log_every=20, chunk=25, track_best_params=False):
    """Chunked training loop: `chunk` epochs run inside ONE jitted
    `lax.scan` (train step + eval per epoch), fetching the metric arrays
    once per chunk instead of syncing with the host ~5 times per epoch.
    Semantics match the eager loop exactly: best-val/test tracked per
    epoch on host from the fetched arrays.

    step_fn(state, rng, d) -> (state, loss); eval_fn(state, d) ->
    (val_acc, test_acc).

    With ``track_best_params=True`` the best-val parameter snapshot is
    kept ON DEVICE in the scan carry (tree-select per epoch), replacing
    the reference's save-weights-on-best without a host sync; the
    snapshot is returned as a 4th value.
    """
    @jax.jit
    def run_chunk(state, rng, best_val_dev, best_params, d):
        def body(carry, _):
            state, rng, bv, bp = carry
            rng, sk = jax.random.split(rng)
            state, loss = step_fn(state, sk, d)
            val, test = eval_fn(state, d)
            if track_best_params:
                better = val > bv
                bp = jax.tree_util.tree_map(
                    lambda new, old: jnp.where(better, new, old),
                    state.params, bp)
                bv = jnp.maximum(val, bv)
            return (state, rng, bv, bp), (loss, val, test)
        (state, rng, bv, bp), out = jax.lax.scan(
            body, (state, rng, best_val_dev, best_params), None,
            length=chunk)
        return state, rng, bv, bp, out

    # one static chunk size = one compile; a trailing partial chunk runs
    # the full length (reported metrics stop at n_epoch)
    chunk = min(chunk, n_epoch)
    best_val, best_test = 0.0, 0.0
    bv_dev = jnp.float32(-jnp.inf)
    bp = state.params if track_best_params else 0
    epoch = 0
    while epoch < n_epoch:
        state, rng, bv_dev, bp, (losses, vals, tests) = run_chunk(
            state, rng, bv_dev, bp, d)
        losses, vals, tests = (np.asarray(losses), np.asarray(vals),
                               np.asarray(tests))
        for i in range(min(chunk, n_epoch - epoch)):
            if vals[i] > best_val:
                best_val, best_test = float(vals[i]), float(tests[i])
            if (epoch + i) % log_every == 0:
                print(f"epoch {epoch + i:4d} loss {losses[i]:.4f} "
                      f"val {vals[i]:.4f} test {tests[i]:.4f}")
        epoch += chunk
    print(f"best val {best_val:.4f} -> test {best_test:.4f}")
    if track_best_params:
        return state, best_val, best_test, bp
    return state, best_val, best_test


def run_simple_node_trainer(model, args, forward_kwargs=None,
                            loss_extra=None):
    """Standard semi-supervised node-classification loop shared by the
    simple full-batch trainers (reference examples/<model>/*_trainer.py all
    follow this flow: dataset -> model -> Adam CE -> best-val test acc)."""
    import optax
    from gammagl_tpu.train import (TrainState, semi_supervised_loss,
                                   accuracy)

    g, num_classes = load_node_dataset(args.dataset, args.dataset_path)
    d = device_graph(g)
    x, ei = d["x"], d["edge_index"]
    fkw = dict(forward_kwargs or {})

    key = jax.random.PRNGKey(args.seed)
    params = model.init({"params": key, "dropout": key}, x, ei, **fkw)
    tx = optax.chain(optax.add_decayed_weights(args.l2_coef),
                     optax.adam(args.lr))
    state = TrainState.create(params=params, tx=tx)

    # NOTE: the graph dict `d` is threaded through as a jit ARGUMENT:
    # closing over device arrays would embed them in the program as
    # constants.
    def train_step(state, rng, d):
        def loss_fn(p):
            logits = model.apply(p, d["x"], d["edge_index"], train=True,
                                 rngs={"dropout": rng}, **fkw)
            loss = semi_supervised_loss(logits, d["y"], d["train_mask"])
            if loss_extra is not None:
                loss = loss + loss_extra(p)
            return loss
        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads), loss

    def evaluate(state, d):
        logits = model.apply(state.params, d["x"], d["edge_index"], **fkw)
        return (accuracy(logits, d["y"], d["val_mask"]),
                accuracy(logits, d["y"], d["test_mask"]))

    rng = jax.random.PRNGKey(args.seed + 1)
    _, _, best_test = run_epoch_loop(state, rng, d, train_step, evaluate,
                                     args.n_epoch)
    return best_test


def linear_probe(emb, d, num_classes, steps=300, lr=1e-2):
    """Logistic-regression probe on frozen embeddings (the SSL examples'
    shared evaluation protocol, reference examples/grace/ etc.)."""
    import optax
    from gammagl_tpu.train import semi_supervised_loss, accuracy
    emb = emb / (jnp.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
    w = jnp.zeros((emb.shape[1], num_classes))
    opt = optax.adam(lr)
    opt_state = opt.init(w)

    # emb / labels passed as jit args (never close over device arrays)
    @jax.jit
    def step(w, opt_state, emb, y, train_mask):
        loss, grads = jax.value_and_grad(
            lambda w: semi_supervised_loss(emb @ w, y, train_mask))(w)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(w, updates), opt_state, loss

    for _ in range(steps):
        w, opt_state, _ = step(w, opt_state, emb, d["y"], d["train_mask"])
    return float(accuracy(emb @ w, d["y"], d["test_mask"]))


def run_two_view_ssl(model, args, embed_fn, num_views_args=6,
                     drop_rates=(0.2, 0.2, 0.3, 0.3)):
    """Shared loop for two-augmented-view contrastive models whose apply
    signature is (x1, ei, w1, x2, ei, w2) -> loss (GRACE family / MERIT /
    GRADE / MAGCL / GCIL).

    Per-view augmentation rates are PER MODEL/DATASET in the reference
    (each trainer exposes --drop_edge_rate_{1,2}/--drop_feature_rate_{1,2},
    reference grace_trainer.py:87-90): callers pass ``drop_rates =
    (edge1, feat1, edge2, feat2)`` or set the matching attributes on
    ``args`` (args wins, so the harness/CLI can sweep them).
    """
    import optax
    from gammagl_tpu.models import drop_edge_and_feature
    from gammagl_tpu.train import TrainState

    de1 = getattr(args, "drop_edge_rate_1", drop_rates[0])
    df1 = getattr(args, "drop_feature_rate_1", drop_rates[1])
    de2 = getattr(args, "drop_edge_rate_2", drop_rates[2])
    df2 = getattr(args, "drop_feature_rate_2", drop_rates[3])

    g, num_classes = load_node_dataset(args.dataset, args.dataset_path)
    d = device_graph(g)
    x, ei = d["x"], d["edge_index"]
    key = jax.random.PRNGKey(args.seed)
    k1, k2 = jax.random.split(key)
    x1, w1 = drop_edge_and_feature(k1, x, ei, de1, df1)
    x2, w2 = drop_edge_and_feature(k2, x, ei, de2, df2)
    params = model.init(key, x1, ei, w1, x2, ei, w2)
    state = TrainState.create(params=params, tx=optax.adam(args.lr))

    @jax.jit
    def step(state, rng, x, ei):
        ka, kb = jax.random.split(rng)
        xa, wa = drop_edge_and_feature(ka, x, ei, de1, df1)
        xb, wb = drop_edge_and_feature(kb, x, ei, de2, df2)
        loss, grads = jax.value_and_grad(
            lambda p: model.apply(p, xa, ei, wa, xb, ei, wb))(state.params)
        return state.apply_gradients(grads), loss

    rng = jax.random.PRNGKey(args.seed + 1)
    for epoch in range(args.n_epoch):
        rng, k = jax.random.split(rng)
        state, loss = step(state, k, x, ei)
        if epoch % 20 == 0 or epoch == args.n_epoch - 1:
            print(f"pretrain {epoch:4d} loss {float(loss):.4f}")

    emb = embed_fn(model, state.params, x, ei)
    acc = linear_probe(emb, d, num_classes)
    print(f"probe test acc {acc:.4f}")
    return acc


def synthetic_hetero(seed=0, n_m=200, n_d=60, c=3, f=32):
    """Synthetic movie/director typed graph with class-correlated structure
    (shared fallback for the hetero example trainers)."""
    from gammagl_tpu.data import HeteroGraph
    rng = np.random.default_rng(seed)
    hg = HeteroGraph()
    y = rng.integers(0, c, n_m)
    x = rng.normal(size=(n_m, f)).astype(np.float32)
    x[np.arange(n_m), y] += 2.0
    hg["movie"].x = x
    hg["movie"].y = y
    hg["director"].x = rng.normal(size=(n_d, f)).astype(np.float32)
    d_of = rng.integers(0, n_d // c, n_m) + (n_d // c) * y
    hg[("director", "directs", "movie")].edge_index = np.stack(
        [d_of, np.arange(n_m)])
    hg[("movie", "by", "director")].edge_index = np.stack(
        [np.arange(n_m), d_of])
    mdm = []
    for d in range(n_d):
        ms = np.nonzero(d_of == d)[0]
        for a in ms:
            for b in ms:
                mdm.append((a, b))
    hg[("movie", "mdm", "movie")].edge_index = np.asarray(mdm).T
    mask = np.zeros(n_m, bool)
    mask[rng.permutation(n_m)[:n_m // 2]] = True
    hg["movie"].train_mask = mask
    hg["movie"].test_mask = ~mask
    return hg, "movie"


def run_hetero_trainer(make_model, args, dataset_loader=None):
    """Shared loop for x_dict/edge_index_dict hetero node classifiers
    (HAN/HGT/HPN/ieHGCN/RoheHAN). `make_model(metadata, num_classes,
    target)` builds the flax module."""
    import optax
    from gammagl_tpu.train import TrainState, accuracy, semi_supervised_loss

    hg, target = None, None
    if dataset_loader is not None:
        try:
            hg, target = dataset_loader(args)
        except Exception as e:
            print(f"[warn] dataset unavailable ({e}); synthetic typed graph")
    if hg is None:
        hg, target = synthetic_hetero()
    hg = hg.tensor() if hasattr(hg, "tensor") else hg
    x_dict = hg.x_dict
    ei_dict = hg.edge_index_dict
    y = jnp.asarray(np.asarray(hg[target].y))
    num_classes = int(np.asarray(y).max()) + 1
    train_mask = jnp.asarray(np.asarray(hg[target].train_mask))
    test_mask = jnp.asarray(np.asarray(hg[target].test_mask))

    model = make_model(hg.metadata(), num_classes, target)
    import inspect
    sig = inspect.signature(model.__call__).parameters
    tkw = {"train": True} if "train" in sig else {}
    key = jax.random.PRNGKey(args.seed)
    params = model.init({"params": key, "dropout": key}, x_dict, ei_dict)
    state = TrainState.create(params=params, tx=optax.adam(args.lr))

    @jax.jit
    def step(state, rng, x_dict, ei_dict, y, train_mask):
        def loss_fn(p):
            logits = model.apply(p, x_dict, ei_dict,
                                 rngs={"dropout": rng}, **tkw)
            return semi_supervised_loss(logits, y, train_mask)
        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads), loss

    @jax.jit
    def eval_acc(state, x_dict, ei_dict, y, test_mask):
        return accuracy(model.apply(state.params, x_dict, ei_dict),
                        y, test_mask)

    rng = jax.random.PRNGKey(args.seed + 1)
    for epoch in range(args.n_epoch):
        rng, k = jax.random.split(rng)
        state, loss = step(state, k, x_dict, ei_dict, y, train_mask)
        if epoch % 10 == 0 or epoch == args.n_epoch - 1:
            acc = eval_acc(state, x_dict, ei_dict, y, test_mask)
            print(f"epoch {epoch:3d} loss {float(loss):.4f} "
                  f"test {float(acc):.4f}")
    acc = float(eval_acc(state, x_dict, ei_dict, y, test_mask))
    print(f"final test acc {acc:.4f}")
    return acc
