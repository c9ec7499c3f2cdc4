"""Graph partitioning for multi-chip full-graph training.

The graph-world analog of context parallelism (SURVEY.md section 5): edges
are partitioned across devices; each device owns a contiguous destination-row
range plus the full (replicated or gathered) source features. Aggregation is
local SpMM + a psum/reduce_scatter across the edge-parallel axis.

Partition strategies:
  * `partition_edges_by_dst` -- 1D edge cut: device d owns edges whose dst
    falls in its row block; dst-local aggregates need no cross-device reduce,
    only the gather of src features crosses chips (done as replication at
    small scale, halo exchange at large scale).
  * `partition_edges_uniform` -- balanced edge count regardless of dst; local
    partial aggregates are summed with `psum` (an all-reduce between devices).
"""

from typing import NamedTuple

import numpy as np

__all__ = ["EdgePartition", "partition_edges_by_dst",
           "partition_edges_uniform", "balance_permutation"]


class EdgePartition(NamedTuple):
    """Padded per-device edge shards, stackable to (P, 2, E_shard)."""

    edge_index: np.ndarray   # (P, 2, E_shard) padded with num_nodes
    edge_weight: np.ndarray  # (P, E_shard) padded with 0 (or None)
    row_start: np.ndarray    # (P,) first dst row owned (dst strategy only)
    num_parts: int
    num_nodes: int


def _pad_shards(shards, wshards, num_nodes, num_parts):
    e_max = max(s.shape[1] for s in shards)
    # round up to 128 so shard shapes repeat across graphs of similar size
    e_max = -(-e_max // 128) * 128
    ei = np.full((num_parts, 2, e_max), num_nodes, dtype=np.int32)
    w = np.zeros((num_parts, e_max), dtype=np.float32)
    for p, s in enumerate(shards):
        ei[p, :, :s.shape[1]] = s
        if wshards[p] is not None:
            w[p, :s.shape[1]] = wshards[p]
        else:
            w[p, :s.shape[1]] = 1.0
    return ei, w


def partition_edges_by_dst(edge_index, num_nodes, num_parts,
                           edge_weight=None):
    """Edge cut by destination row blocks of size ceil(N / P)."""
    ei = np.asarray(edge_index)
    w = None if edge_weight is None else np.asarray(edge_weight)
    rows_per = -(-num_nodes // num_parts)
    owner = np.minimum(ei[1] // rows_per, num_parts - 1)
    shards, wshards, starts = [], [], []
    for p in range(num_parts):
        mask = owner == p
        shards.append(ei[:, mask])
        wshards.append(None if w is None else w[mask])
        starts.append(p * rows_per)
    ei_p, w_p = _pad_shards(shards, wshards, num_nodes, num_parts)
    return EdgePartition(ei_p, w_p, np.asarray(starts, np.int32),
                         num_parts, num_nodes)


def partition_edges_uniform(edge_index, num_nodes, num_parts,
                            edge_weight=None):
    """Balanced edge-count shards (dst arbitrary; requires cross-device sum)."""
    ei = np.asarray(edge_index)
    w = None if edge_weight is None else np.asarray(edge_weight)
    E = ei.shape[1]
    bounds = np.linspace(0, E, num_parts + 1).astype(np.int64)
    shards, wshards = [], []
    for p in range(num_parts):
        sl = slice(bounds[p], bounds[p + 1])
        shards.append(ei[:, sl])
        wshards.append(None if w is None else w[sl])
    ei_p, w_p = _pad_shards(shards, wshards, num_nodes, num_parts)
    return EdgePartition(ei_p, w_p, np.zeros(num_parts, np.int32),
                         num_parts, num_nodes)


def balance_permutation(edge_index, num_nodes, num_parts, row_align=8):
    """Degree-balanced node relabeling for the block-owner halo partitions.

    The halo tiers assign node v to device ``v // rows_per``; on skewed
    (power-law) graphs a natural ordering concentrates high in-degree
    nodes in a few blocks, inflating the padded per-device edge count
    (observed 2x at arxiv scale -> ~50% scaling efficiency). This deals
    nodes to the P owner blocks greedily by in-degree (largest-first
    into the lightest unfilled block) so every block owns ~equal edges.

    Returns ``(perm, inv)`` with the `reorder_bandwidth` contract:
    relabel edges with ``ei = inv[ei]``, reorder node data with
    ``x = x[perm]``. New ids stay dense in [0, num_nodes): parts
    0..P-2 receive exactly ``rows_per`` nodes, the last the remainder.
    Falls back to identity when the graph is too small to fill P-1
    aligned blocks.
    """
    ei = np.asarray(edge_index)
    ceil_rows = -(-num_nodes // num_parts)
    rows_per = -(-ceil_rows // row_align) * row_align  # align like halo._round_up
    caps = np.full(num_parts, rows_per, np.int64)
    caps[-1] = num_nodes - (num_parts - 1) * rows_per
    if caps[-1] < 0:  # tiny graph: blocks cannot all be aligned-full
        ident = np.arange(num_nodes, dtype=np.int64)
        return ident, ident
    indeg = np.bincount(ei[1], minlength=num_nodes).astype(np.int64)
    order = np.argsort(-indeg, kind="stable")
    load = np.zeros(num_parts, np.float64)
    fill = np.zeros(num_parts, np.int64)
    assign = np.empty(num_nodes, np.int64)
    big = np.inf
    for v in order:
        masked = np.where(fill < caps, load, big)
        p = int(np.argmin(masked))
        assign[v] = p
        fill[p] += 1
        load[p] += indeg[v]
    # new id = block offset + arrival order within the block
    starts = np.arange(num_parts, dtype=np.int64) * rows_per
    fill[:] = 0
    inv = np.empty(num_nodes, np.int64)
    for v in order:
        p = assign[v]
        inv[v] = starts[p] + fill[p]
        fill[p] += 1
    perm = np.empty(num_nodes, np.int64)
    perm[inv] = np.arange(num_nodes)
    return perm, inv
