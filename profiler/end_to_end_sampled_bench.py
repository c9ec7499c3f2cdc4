"""End-to-end sampled-minibatch training epoch at the Reddit protocol.

Reference point (reference profiler/sampler/readme.md:10-24, sampling-only
epoch over Reddit with fanout [25,10], batch 1024): PyG 9.47 s, GGL-CPU
11.26 s, GGL-GPU 2.28 s. This bench measures the FULL training epoch
(sample + pad + feature fetch + fwd/bwd step) for this pipeline:
C++ host sampler (OpenMP presample chunks) -> bucket padding -> device-resident
feature gather (DeviceFeatureCache) -> jit'd SAGE step, with host work
pipelined behind the device step.

Usage: python profiler/end_to_end_sampled_bench.py [--nodes N --edges E]
"""

import argparse
import os.path as osp
import sys
import time

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp
import optax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=232_965)
    ap.add_argument("--edges", type=int, default=11_460_000)
    ap.add_argument("--feat", type=int, default=602)
    ap.add_argument("--classes", type=int, default=41)
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--batches", type=int, default=0,
                    help="0 = full epoch (nodes // batch_size)")
    ap.add_argument("--presample_chunks", type=int, default=8)
    ap.add_argument("--resample_every", type=int, default=5,
                    help=">1: EpochCache replays sampled batches between "
                         "resampling epochs; also times a replay epoch")
    args = ap.parse_args()

    from gammagl_tpu.utils import enable_compile_cache
    enable_compile_cache()
    from gammagl_tpu.loader import DeviceFeatureCache, pipeline
    from gammagl_tpu.data.padding import size_bucket
    from gammagl_tpu.models import GraphSAGESampleModel
    from gammagl_tpu.train import TrainState

    rng = np.random.default_rng(0)
    ei = np.stack([rng.integers(0, args.nodes, args.edges),
                   rng.integers(0, args.nodes, args.edges)])
    x_all = rng.normal(size=(args.nodes, args.feat)).astype(np.float32)
    y_all = rng.integers(0, args.classes, args.nodes).astype(np.int32)
    n_batches = args.batches or args.nodes // args.batch_size
    seeds = rng.permutation(args.nodes)[:n_batches * args.batch_size]

    fcache = DeviceFeatureCache(x_all, budget_rows=args.nodes)

    model = GraphSAGESampleModel(hidden_dim=64, num_class=args.classes,
                                 num_layers=2, drop_rate=0.0)

    from gammagl_tpu.loader import EpochCache, NeighborSamplerLoader
    loader = NeighborSamplerLoader(ei, node_idx=seeds,
                                   sample_lists=[25, 10],
                                   batch_size=args.batch_size,
                                   num_nodes=args.nodes, shuffle=False,
                                   seed=0,
                                   presample_chunks=args.presample_chunks)
    if args.resample_every > 1:
        loader = EpochCache(loader, resample_every=args.resample_every,
                            reshuffle=False)

    def pad_batch_ids(bs, n_id, adjs):
        n_pad = int(size_bucket(len(n_id)))
        n_id_p = np.full(n_pad, n_id[-1], dtype=n_id.dtype)
        n_id_p[:len(n_id)] = n_id
        eis, sizes = [], []
        for i, a in enumerate(adjs):
            size_dst = (int(bs) if i == len(adjs) - 1
                        else int(size_bucket(int(a.size[1]))))
            e_pad = int(size_bucket(int(a.edge_index.shape[1])))
            e = np.full((2, e_pad), size_dst, dtype=np.int64)
            e[:, :a.edge_index.shape[1]] = a.edge_index
            eis.append(e)
            sizes.append(size_dst)
        return n_id_p, eis, tuple(sizes)

    def device_batches():
        for bs, n_id, adjs in loader:
            if bs < args.batch_size:
                continue
            n_id_p, eis, sizes = pad_batch_ids(bs, n_id, adjs)
            feats = fcache[n_id_p]
            yield (feats, [jnp.asarray(e) for e in eis], sizes,
                   jnp.asarray(y_all[n_id[:bs]]))

    from functools import partial

    @partial(jax.jit, static_argnames=("sizes",))
    def train_step(state, feats, eis, sizes, y):
        def loss_fn(p):
            logits = model.apply(p, feats, list(zip(eis, sizes)))
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()
        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads), loss

    # init + warm-epoch: compile every bucket combination before timing
    it0 = device_batches()
    feats, eis, sizes, y = next(it0)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "dropout": key}, feats,
                        list(zip(eis, sizes)))
    state = TrainState.create(params=params, tx=optax.adam(1e-3))
    state, loss = train_step(state, feats, eis, sizes, y)
    for feats, eis, sizes, y in it0:
        state, loss = train_step(state, feats, eis, sizes, y)
    jax.block_until_ready(loss)

    cases = [("serial", False, True), ("pipelined", True, True)]
    if args.resample_every > 1:
        cases.append(("cached replay", False, False))
    for label, pre, fresh in cases:
        if fresh and hasattr(loader, "invalidate"):
            loader.invalidate()  # time a genuinely fresh sampling epoch
        it = device_batches()
        if pre:
            it = pipeline(it, size=2)
        t0 = time.perf_counter()
        losses = []
        nb = 0
        for feats, eis, sizes, y in it:
            state, loss = train_step(state, feats, eis, sizes, y)
            losses.append(loss)
            nb += 1
        jax.block_until_ready(losses[-1])
        dt = time.perf_counter() - t0
        print(f"{label}: {nb} batches, epoch {dt:.2f}s "
              f"({dt / nb * 1e3:.1f} ms/batch)  "
              f"[reference sampling-only epoch: GGL-CPU 11.26s, "
              f"GGL-GPU 2.28s, PyG 9.47s]")


if __name__ == "__main__":
    main()
