"""Halo exchange: node-partitioned full-graph aggregation over a mesh.

The graph world's context parallelism (SURVEY.md sections 5/7 -- net-new, no
reference code): nodes are partitioned into contiguous row blocks, one per
device along the 'dp' axis; destination-owned edges stay local, and the
boundary ("halo") source features each device needs from its peers are
exchanged with ONE `all_to_all` per layer. After the exchange,
aggregation is a purely local segment-sum into owned rows -- no psum over
full feature matrices (unlike `gammagl_tpu.parallel.spmm`, which replicates
features and all-reduces; that tier is for small graphs).

Scaling shape: per layer each device moves O(boundary x F) bytes instead of
O(N x F); with a locality-preserving node order (e.g. BFS/METIS, see
`reorder_bandwidth`) boundary << N.

Host-side `build_halo_partition` precomputes, per device:
  * its padded local edge list (src pre-remapped into [own block | halo
    buffer], padded dst -> dropped by scatter),
  * `send_idx[q]`: which of its rows each peer q needs (padded; clamped
    gather, receivers never reference pad slots).
"""

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gammagl_tpu.ops import segment_sum

__all__ = ["HaloPartition", "build_halo_partition", "make_halo_spmm",
           "reorder_bandwidth"]


class HaloPartition(NamedTuple):
    edge_index: np.ndarray   # (P, 2, E_max) local (src_local, dst_local)
    edge_weight: np.ndarray  # (P, E_max), 0 at pads
    send_idx: np.ndarray     # (P, P, H) local row ids to send to peer q
    num_parts: int
    rows_per: int            # owned rows per device (last block padded)
    halo_per_peer: int       # H
    num_nodes: int
    # balanced relabeling (default-on): new_id = node_inv[old_id]. Node
    # data must be reordered with x[node_perm] — `pad_nodes`/`shard_nodes`
    # do it automatically; un-permute results with [node_inv]. None =
    # natural order (balance=False or identity permutation).
    node_perm: object = None
    node_inv: object = None

    @property
    def halo_total(self):
        return self.num_parts * self.halo_per_peer


def _round_up(x, m):
    return -(-x // m) * m


def _halo_sets(edge_index, num_nodes, num_parts, edge_weight=None,
               row_align=8):
    """Shared host-side partition analysis (also used by halo_attention.py).

    Returns (rows_per, H, part_edges, halo, send_idx):
      part_edges[p] = (sub (2,E_p) global ids, w_p, src_owner_p)
      halo[p][q]    = sorted global src ids device p needs from q
      send_idx      = (P, P, H) local row ids each OWNER sends to each peer
    """
    ei = np.asarray(edge_index)
    w = (np.asarray(edge_weight) if edge_weight is not None
         else np.ones(ei.shape[1], np.float32))
    rows_per = _round_up(-(-num_nodes // num_parts), row_align)
    owner_dst = np.minimum(ei[1] // rows_per, num_parts - 1)
    owner_src = np.minimum(ei[0] // rows_per, num_parts - 1)

    # halo sets: for each (p consumer, q owner) the global src ids needed
    halo = [[np.empty(0, np.int64)] * num_parts for _ in range(num_parts)]
    part_edges = []
    for p in range(num_parts):
        mask = owner_dst == p
        sub = ei[:, mask]
        sub_src_owner = owner_src[mask]
        for q in range(num_parts):
            if q == p:
                continue
            halo[p][q] = np.unique(sub[0][sub_src_owner == q])
        part_edges.append((sub, w[mask], sub_src_owner))

    H = max([1] + [len(halo[p][q]) for p in range(num_parts)
                   for q in range(num_parts)])
    H = _round_up(H, 8)
    send_idx = np.zeros((num_parts, num_parts, H), np.int32)
    for p in range(num_parts):
        for q in range(num_parts):
            if q == p:
                continue
            # q must send device p the rows halo[p][q]: SENDER-side record
            send_idx[q, p, :len(halo[p][q])] = halo[p][q] - q * rows_per
    return rows_per, H, part_edges, halo, send_idx


def _balanced_relabel(edge_index, num_nodes, num_parts):
    """(relabeled_ei, perm, inv) or (ei, None, None) when identity.

    Default-on for every halo builder: on power-law graphs the natural
    ordering concentrates in-degree in a few owner blocks (2x padded-edge
    inflation at arxiv scale -> ~50% scaling efficiency; BASELINE target
    is >=75%). `balance_permutation` deals nodes to blocks by in-degree
    so the default invocation hits the target; pass ``balance=False``
    to keep the caller's node order (e.g. when an external partitioner
    already placed the rows).
    """
    from gammagl_tpu.parallel.partition import balance_permutation
    ei = np.asarray(edge_index)
    if num_parts <= 1:   # single owner block: nothing to balance
        return ei, None, None
    perm, inv = balance_permutation(ei, num_nodes, num_parts)
    if np.array_equal(perm, np.arange(num_nodes)):
        return ei, None, None
    return inv[ei], perm, inv


def build_halo_partition(edge_index, num_nodes, num_parts,
                         edge_weight=None, balance=True):
    """Contiguous node blocks; edges assigned to the dst owner.

    ``balance`` (default) relabels nodes with `balance_permutation` so
    every device owns ~equal edges; the permutation rides on the
    partition (`node_perm`/`node_inv`) and `shard_nodes` applies it.
    """
    if balance:
        ei_b, perm, inv = _balanced_relabel(edge_index, num_nodes,
                                            num_parts)
        if perm is not None:
            return build_halo_partition(
                ei_b, num_nodes, num_parts, edge_weight,
                balance=False)._replace(node_perm=perm, node_inv=inv)
        edge_index = ei_b
    rows_per, H, part_edges, halo, send_idx = _halo_sets(
        edge_index, num_nodes, num_parts, edge_weight)
    E_max = _round_up(max(1, max(pe[0].shape[1] for pe in part_edges)), 128)

    edge_out = np.zeros((num_parts, 2, E_max), np.int32)
    w_out = np.zeros((num_parts, E_max), np.float32)
    for p in range(num_parts):
        sub, sub_w, sub_src_owner = part_edges[p]
        E_p = sub.shape[1]
        # local src ids: own rows first, then halo buffer laid out
        # [peer 0 | peer 1 | ...] each H wide (own slot left unused)
        src_local = np.empty(E_p, np.int64)
        own = sub_src_owner == p
        src_local[own] = sub[0][own] - p * rows_per
        for q in range(num_parts):
            if q == p:
                continue
            sel = sub_src_owner == q
            if not sel.any():
                continue
            pos = np.searchsorted(halo[p][q], sub[0][sel])
            src_local[sel] = rows_per + q * H + pos
        dst_local = sub[1] - p * rows_per
        edge_out[p, 0, :E_p] = src_local
        edge_out[p, 1, :E_p] = dst_local
        # pads: dst = rows_per (scatter-dropped), weight 0
        edge_out[p, 1, E_p:] = rows_per
        w_out[p, :E_p] = sub_w
    return HaloPartition(edge_out, w_out, send_idx, num_parts, rows_per,
                         H, num_nodes)


def make_halo_spmm(mesh: Mesh, part: HaloPartition, axis: str = "dp"):
    """Jit-able halo SpMM: (x_sharded (P*rows_per, F)) -> same sharding.

    Per device: gather send rows -> all_to_all -> local
    segment-sum of [own | halo] features into owned rows.
    """
    rows_per, H, nparts = part.rows_per, part.halo_per_peer, part.num_parts

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(axis), P(axis)),
             out_specs=P(axis))
    def _spmm(x_blk, ei, w, send_idx):
        # x_blk (rows_per, F); send_idx (1, P, H); ei (1, 2, E)
        send = jnp.take(x_blk, send_idx[0].reshape(-1), axis=0,
                        mode="clip")
        send = send.reshape(nparts, H, -1)
        recv = jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0,
                                  tiled=False)
        # recv[q] = rows this device needs from peer q
        table = jnp.concatenate([x_blk, recv.reshape(nparts * H, -1)],
                                axis=0)
        src, dst = ei[0, 0], ei[0, 1]
        msg = jnp.take(table, src, axis=0, mode="clip") * w[0][:, None]
        return segment_sum(msg, dst, rows_per)

    def run(x_sharded):
        return _spmm(x_sharded,
                     jnp.asarray(part.edge_index),
                     jnp.asarray(part.edge_weight),
                     jnp.asarray(part.send_idx))

    return run


def reorder_bandwidth(edge_index, num_nodes):
    """Reverse-Cuthill-McKee node reordering to shrink partition boundaries.

    Returns (perm, inv) with new_id = inv[old_id].
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    ei = np.asarray(edge_index)
    a = sp.coo_matrix((np.ones(ei.shape[1]), (ei[0], ei[1])),
                      shape=(num_nodes, num_nodes)).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(num_nodes)
    return perm, inv
