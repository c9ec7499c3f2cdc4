"""Multi-host input pipeline (net-new; SURVEY.md §2.10 / §7.7).

The reference has no distributed execution at all — its only multi-device
facility is CUDA-IPC sampler/feature sharing (gammagl/gglspeedup/
multigpusample.py:104-140). Across hosts every process runs the same SPMD
program, so the input pipeline must (a) give each host a disjoint seed
shard, (b) sample minibatches host-locally, (c) pad them to identical
static shapes, and (d) assemble *global* `jax.Array`s whose batch axis is
sharded over the data-parallel mesh axis — each host materializing only
its addressable shard (`jax.make_array_from_process_local_data`).

Single-process testability: with `process_count == 1` and a virtual
8-device CPU mesh the same code path builds the fully-sharded global
batch, so the pipeline is exercised in CI exactly as it runs on a pod.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gammagl_tpu.loader.node_loader import NodeLoader, filter_graph

__all__ = ["shard_seeds", "make_global_batch", "MultiHostNodeLoader",
           "pad_sampled_graph"]


def shard_seeds(seeds, process_index=None, process_count=None,
                drop_remainder=True):
    """Disjoint, equal-length per-host seed shards.

    Equal length is mandatory: every host must run the same number of
    steps or the collective program deadlocks. With drop_remainder the
    tail (< process_count seeds) is dropped, matching the usual epoch
    semantics of distributed loaders.
    """
    seeds = np.asarray(seeds)
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    per = len(seeds) // pc
    if per == 0:
        raise ValueError(
            f"{len(seeds)} seeds cannot be split across {pc} hosts")
    if not drop_remainder and len(seeds) % pc:
        per += 1
        pad = per * pc - len(seeds)
        seeds = np.concatenate([seeds, seeds[:pad]])
    return seeds[pi * per:(pi + 1) * per]


def make_global_batch(mesh: Mesh, tree, spec=P("dp")):
    """Assemble process-local numpy arrays into global jax.Arrays sharded
    by `spec` over `mesh`. Each local array is this host's shard of the
    global batch axis (global size = local * process_count along dim 0).
    """
    def one(x):
        x = np.asarray(x)
        sh = NamedSharding(mesh, spec if x.ndim else P())
        return jax.make_array_from_process_local_data(sh, x)
    return jax.tree_util.tree_map(one, tree)


def pad_sampled_graph(sub, num_nodes, num_edges, num_seeds):
    """Pad a sampled subgraph to static (num_nodes, num_edges) buckets.

    Padding rules that make masked entries exact no-ops downstream
    (SURVEY.md §7 hard-parts): padded edges point src=dst=num_nodes-1 with
    weight 0 is NOT enough for segment_max-style reduces, so padded edges
    are routed to the last *padding* node (never a seed; seeds are always
    the first `batch_size` rows of a sampled block).

    Returns dict of numpy arrays:
      x (num_nodes, F), y (num_nodes,), edge_index (2, num_edges),
      edge_mask (num_edges,), node_mask (num_nodes,), seed_mask
      (num_nodes,), n_id (num_nodes,)
    """
    n, e = sub.num_nodes, sub.edge_index.shape[1]
    if n > num_nodes or e > num_edges:
        raise ValueError(f"bucket too small: ({n},{e}) vs "
                         f"({num_nodes},{num_edges})")
    out = {}
    x = np.asarray(sub.x)
    out["x"] = np.pad(x, ((0, num_nodes - n),) + ((0, 0),) * (x.ndim - 1))
    if getattr(sub, "y", None) is not None:
        y = np.asarray(sub.y)
        out["y"] = np.pad(y, ((0, num_nodes - n),) + ((0, 0),) *
                          (y.ndim - 1))
    ei = np.asarray(sub.edge_index)
    pad_dst = num_nodes - 1  # a padding row unless the block is full
    ei_pad = np.full((2, num_edges - e), pad_dst, ei.dtype)
    out["edge_index"] = np.concatenate([ei, ei_pad], axis=1)
    out["edge_mask"] = (np.arange(num_edges) < e)
    out["node_mask"] = (np.arange(num_nodes) < n)
    seed = np.zeros(num_nodes, bool)
    seed[:sub.batch_size] = True
    out["seed_mask"] = seed
    out["n_id"] = np.pad(np.asarray(sub.n_id), (0, num_nodes - n),
                         constant_values=pad_dst)
    return out


class MultiHostNodeLoader:
    """Per-host neighbor-sampled minibatches assembled into global,
    dp-sharded device batches.

    Every host constructs the loader with the SAME input_nodes and seed;
    `shard_seeds` then gives each host its disjoint shard, and shuffling
    uses the shared seed so epoch boundaries stay aligned. Yields dicts of
    global `jax.Array`s with leading axis batch-sharded over `axis`.

    node_bucket/edge_bucket are the static padded shapes (one jit
    compilation for the whole epoch). The per-host sub-batch is
    `batch_size`; the global batch axis is stacked over hosts *and* this
    host's local steps, i.e. global leading dim = dp size of the mesh.
    """

    def __init__(self, graph, sampler, mesh, input_nodes=None,
                 batch_size=512, node_bucket=None, edge_bucket=None,
                 axis="dp", shuffle=True, seed=0, process_index=None,
                 process_count=None):
        self.mesh = mesh
        self.axis = axis
        pc = (jax.process_count() if process_count is None
              else process_count)
        dp = mesh.shape[axis]
        if dp % pc:
            raise ValueError(f"mesh axis '{axis}'={dp} not divisible by "
                             f"process_count={pc}")
        self.shards_per_host = dp // pc
        if input_nodes is None:
            input_nodes = np.arange(graph.num_nodes)
        self.all_seeds = np.asarray(input_nodes)
        self.pi = (jax.process_index() if process_index is None
                   else process_index)
        self.pc = pc
        self.graph = graph
        self.sampler = sampler
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        if node_bucket is None or edge_bucket is None:
            fan = getattr(sampler, "num_neighbors", [10, 10])
            est = batch_size
            tot, e_tot = est, 0
            for f in fan:
                est = est * max(int(f), 1)
                e_tot += est
                tot += est
            node_bucket = node_bucket or int(tot * 1.1) + 1
            edge_bucket = edge_bucket or int(e_tot * 1.1) + 1
        self.node_bucket = node_bucket
        self.edge_bucket = edge_bucket

    def __len__(self):
        per_host = len(self.all_seeds) // self.pc
        return per_host // (self.batch_size * self.shards_per_host)

    def __iter__(self):
        order = self.all_seeds.copy()
        if self.shuffle:
            # same permutation on every host: epoch-synchronized shuffle
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        mine = shard_seeds(order, self.pi, self.pc)
        group = self.batch_size * self.shards_per_host
        steps = len(mine) // group
        for s in range(steps):
            blk = mine[s * group:(s + 1) * group]
            shards = []
            for k in range(self.shards_per_host):
                seeds = blk[k * self.batch_size:(k + 1) * self.batch_size]
                out = self.sampler.sample_from_nodes(seeds)
                sub = filter_graph(self.graph, out)
                shards.append(pad_sampled_graph(
                    sub, self.node_bucket, self.edge_bucket,
                    len(seeds)))
            local = {k: np.stack([s[k] for s in shards])
                     for k in shards[0]}
            yield make_global_batch(self.mesh, local, P(self.axis))
