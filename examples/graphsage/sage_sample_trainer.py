"""Minibatch GraphSAGE with neighbor sampling (reference:
examples/graphsage/reddit_sage_trainer.py flow: NeighborSampler -> gather
features -> bipartite SAGE blocks -> train step).

Runs on Reddit when available, else a synthetic graph. Host sampling uses
the native C++ core; batches are prefetched onto the device.
"""

import os.path as osp
import sys
import time

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp
import optax

from common import base_parser
from gammagl_tpu.loader import EpochCache, NeighborSamplerLoader
from gammagl_tpu.models import GraphSAGESampleModel
from gammagl_tpu.train import TrainState, accuracy


def load(args):
    try:
        from gammagl_tpu.datasets import Reddit
        ds = Reddit(root=args.dataset_path)
        g = ds[0]
        return g, int(np.asarray(g.y).max()) + 1
    except Exception as e:
        print(f"[warn] reddit unavailable ({e}); synthetic graph")
        from gammagl_tpu.datasets import synthetic_community_graph
        g = synthetic_community_graph(5000, 16, 64, avg_degree=12, seed=0)
        return g, 16


def main(args):
    graph, num_classes = load(args)
    x_all = np.asarray(graph.x)
    y_all = np.asarray(graph.y)
    train_idx = np.nonzero(np.asarray(graph.train_mask))[0]
    loader = NeighborSamplerLoader(
        np.asarray(graph.edge_index), node_idx=train_idx,
        sample_lists=[args.fanout1, args.fanout2],
        batch_size=args.batch_size, num_nodes=graph.num_nodes,
        shuffle=True, seed=args.seed,
        presample_chunks=args.presample_chunks)
    if args.resample_every > 1:
        # replay cached samples between resampling epochs: on hosts whose
        # sampler is slower than the device step this makes epochs 1..k-1
        # device-bound
        loader = EpochCache(loader, resample_every=args.resample_every,
                            seed=args.seed)

    model = GraphSAGESampleModel(hidden_dim=args.hidden_dim,
                                 num_class=num_classes, num_layers=2,
                                 drop_rate=args.drop_rate)

    from functools import partial
    from gammagl_tpu.data.padding import size_bucket

    def pad_batch_ids(bs, n_id, adjs):
        """Bucket-pad blocks so jit compiles once per bucket: padded edges
        point dst to the (bucketed) size_dst -> scatter-dropped; padded
        node ids repeat the last real id (harmless gathers)."""
        n_pad = size_bucket(len(n_id))
        n_id_p = np.full(n_pad, n_id[-1], dtype=n_id.dtype)
        n_id_p[:len(n_id)] = n_id
        eis, sizes = [], []
        for i, a in enumerate(adjs):
            size_dst = (int(bs) if i == len(adjs) - 1
                        else int(size_bucket(int(a.size[1]))))
            e_pad = int(size_bucket(int(a.edge_index.shape[1])))
            ei = np.full((2, e_pad), size_dst, dtype=np.int64)
            ei[:, :a.edge_index.shape[1]] = a.edge_index
            eis.append(ei)
            sizes.append(size_dst)
        return n_id_p, eis, tuple(sizes)

    bs, n_id, adjs = loader.sample(train_idx[:args.batch_size])
    n_id_p, eis, sizes = pad_batch_ids(bs, n_id, adjs)
    feats = jnp.asarray(x_all[n_id_p])
    key = jax.random.PRNGKey(args.seed)
    params = model.init({"params": key, "dropout": key}, feats,
                        list(zip([jnp.asarray(e) for e in eis], sizes)))
    state = TrainState.create(params=params, tx=optax.adam(args.lr))

    @partial(jax.jit, static_argnames=("sizes",))
    def train_step(state, feats, eis, sizes, y, rng):
        model_adjs = list(zip(eis, sizes))
        def loss_fn(p):
            logits = model.apply(p, feats, model_adjs, train=True,
                                 rngs={"dropout": rng})
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean(), logits
        (loss, logits), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        return state.apply_gradients(grads), loss, logits

    # Input pipeline (the gglspeedup tier, SURVEY section 2.6):
    # features stay RESIDENT in device memory (DeviceFeatureCache) so each
    # batch moves only node ids + edge blocks to the device and gathers
    # features there; host sampling + padding runs in a background thread
    # (prefetch) overlapping the device step; per-step metrics stay on device
    # and sync once per epoch.
    from gammagl_tpu.loader import DeviceFeatureCache
    from gammagl_tpu.loader.prefetch import pipeline
    from gammagl_tpu.utils import degree

    deg = np.asarray(degree(jnp.asarray(graph.edge_index[1]),
                            graph.num_nodes))
    fcache = DeviceFeatureCache(x_all, budget_rows=graph.num_nodes
                                if args.device_cache else 0, score=deg)

    def device_batches():
        for bs, n_id, adjs in loader:
            if bs < args.batch_size:
                continue
            n_id_p, eis, sizes = pad_batch_ids(bs, n_id, adjs)
            feats = fcache[n_id_p]          # on-device gather (hot rows)
            yield (feats, [jnp.asarray(e) for e in eis], sizes,
                   jnp.asarray(y_all[n_id[:bs]]))

    rng = jax.random.PRNGKey(args.seed + 1)
    for epoch in range(args.n_epoch):
        t0 = time.time()
        losses, corrects, tot = [], [], 0
        it = device_batches()
        if args.prefetch:
            it = pipeline(it, size=2)
        for feats, eis, sizes, y in it:
            rng, step_rng = jax.random.split(rng)
            state, loss, logits = train_step(state, feats, eis, sizes, y,
                                             step_rng)
            losses.append(loss)            # device scalars; no sync here
            corrects.append((jnp.argmax(logits, -1) == y).sum())
            tot += int(y.shape[0])
        tot_loss = float(sum(losses)) / max(len(losses), 1)
        tot_correct = float(sum(corrects))
        print(f"epoch {epoch} loss {tot_loss:.4f} "
              f"train acc {tot_correct / tot:.4f} "
              f"({time.time() - t0:.1f}s, "
              f"cache hit {fcache.hits}/{fcache.hits + fcache.misses})",
              flush=True)

    # sampled TEST accuracy (the reference Reddit protocol reports test
    # acc, reddit_sage_trainer.py): fresh sampler over test seeds, no
    # dropout
    test_idx = np.nonzero(np.asarray(graph.test_mask))[0] \
        if "test_mask" in graph.keys() else train_idx
    eval_loader = NeighborSamplerLoader(
        np.asarray(graph.edge_index), node_idx=test_idx,
        sample_lists=[args.fanout1, args.fanout2],
        batch_size=args.batch_size, num_nodes=graph.num_nodes,
        shuffle=False, seed=args.seed)

    @partial(jax.jit, static_argnames=("sizes",))
    def eval_logits(state, feats, eis, sizes):
        return model.apply(state.params, feats, list(zip(eis, sizes)))

    correct = total = 0
    for bs, n_id, adjs in eval_loader:
        if len(n_id) == 0:
            continue
        n_id_p, eis, sizes = pad_batch_ids(bs, n_id, adjs)
        feats = fcache[n_id_p]
        logits = eval_logits(state, feats,
                             tuple(jnp.asarray(e) for e in eis), sizes)
        yb = y_all[n_id[:bs]]
        correct += int((np.asarray(jnp.argmax(logits, -1))[:bs] == yb
                        ).sum())
        total += int(bs)
    acc = correct / max(total, 1)
    print(f"test acc {acc:.4f} ({total} nodes)")
    return acc


if __name__ == "__main__":
    parser = base_parser(hidden_dim=64, n_epoch=3, lr=0.003)
    parser.add_argument("--batch_size", type=int, default=512)
    parser.add_argument("--fanout1", type=int, default=25)
    parser.add_argument("--fanout2", type=int, default=10)
    parser.add_argument("--device_cache", type=int, default=1)
    # thread prefetch lost to serial + OpenMP presample on a 2-core host;
    # enable on hosts with more cores
    parser.add_argument("--prefetch", type=int, default=0)
    parser.add_argument("--presample_chunks", type=int, default=4)
    parser.add_argument("--resample_every", type=int, default=1,
                        help=">1 replays cached samples between "
                             "resampling epochs (EpochCache)")
    main(parser.parse_args())
