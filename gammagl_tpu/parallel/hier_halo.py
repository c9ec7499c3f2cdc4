"""Two-level halo exchange: one level within a host, one across hosts.

`gammagl_tpu.parallel.halo` assumes one fast interconnect: every boundary
row moves with a single flat `all_to_all`, and a row needed by k devices of
a remote host crosses the slow inter-host link k times. This module is the
multi-host tier (SURVEY.md sections 5/7 -- net-new, the reference has no
distributed execution at all): the mesh is 2-D `('slice', 'dp')` (one
slice per host), nodes are partitioned slice-major into contiguous blocks,
and each layer's boundary exchange runs in three phases:

  1. **intra** -- `all_to_all` over `dp` (intra-host): same-host halo rows,
     exactly the single-level scheme per host.
  2. **inter** -- `all_to_all` over `slice` (inter-host): halo rows
     deduplicated at *host* granularity. `R[s][t][d]` = rows owned by
     device `(s, d)` that ANY device of host `t` references; each such row
     crosses the inter-host link once per consumer host, and because the
     `dp` coordinate is held fixed the traffic is spread across all `D`
     devices' network links of the host instead of funneling through one.
  3. **redistribute** -- `all_gather` over `dp` (intra-host): the received
     inter-host rows are shared within the consumer host, giving every
     device the same `(D, S, H2)` halo table.

Local edge lists are pre-remapped on the host so source ids index the
concatenated ``[own rows | intra halo | inter halo]`` table; aggregation is
then a purely local segment-sum (pads scatter-dropped), identical in spirit
to `halo.make_halo_spmm`.

`traffic_report` quantifies the win: inter-host bytes/layer under this
scheme vs the flat single-level `all_to_all` (which would push every
duplicate row across the inter-host link).
"""

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gammagl_tpu.ops import segment_sum

__all__ = ["HierHaloPartition", "build_hier_halo_partition",
           "make_hier_halo_spmm", "traffic_report"]


def _round_up(x, m):
    return -(-x // m) * m


class HierHaloPartition(NamedTuple):
    edge_index: np.ndarray   # (S, D, 2, E_max) local (src_local, dst_local)
    edge_weight: np.ndarray  # (S, D, E_max), 0 at pads
    send_intra: np.ndarray   # (S, D, D, H1) own-row ids for dp-peer q
    send_inter: np.ndarray   # (S, D, S, H2) own-row ids for consumer slice t
    num_slices: int          # S
    dp_per_slice: int        # D
    rows_per: int            # owned rows per device
    h_intra: int             # H1
    h_inter: int             # H2
    num_nodes: int
    # inter-/intra-host row counts for traffic_report (valid, un-padded)
    inter_rows: int          # sum over (s,t,d) |R[s][t][d]|
    inter_rows_flat: int     # what a flat all_to_all would push across hosts
    intra_rows: int
    # balanced relabeling (default-on; see halo.HaloPartition.node_perm)
    node_perm: object = None
    node_inv: object = None

    @property
    def num_parts(self):
        return self.num_slices * self.dp_per_slice


def build_hier_halo_partition(edge_index, num_nodes, num_slices,
                              dp_per_slice, edge_weight=None,
                              balance=True):
    """Slice-major contiguous node blocks; edges assigned to the dst owner.

    Device ``(s, d)`` owns global rows ``[(s*D+d)*rows_per, ...)``. Source
    ids in each device's edge list are remapped to the local table
    ``[0, rows_per)`` own | ``rows_per + q*H1 + i`` intra (dp-peer q) |
    ``rows_per + D*H1 + (d_owner*S + s)*H2 + i`` inter (slice s, owner d).

    ``balance`` (default) applies the in-degree-balanced relabeling over
    the S*D owner blocks (see halo.build_halo_partition).
    """
    S, D = int(num_slices), int(dp_per_slice)
    nparts = S * D
    if balance:
        from gammagl_tpu.parallel.halo import _balanced_relabel
        ei_b, perm, inv = _balanced_relabel(edge_index, num_nodes, nparts)
        if perm is not None:
            return build_hier_halo_partition(
                ei_b, num_nodes, num_slices, dp_per_slice, edge_weight,
                balance=False)._replace(node_perm=perm, node_inv=inv)
        edge_index = ei_b
    ei = np.asarray(edge_index)
    w = (np.asarray(edge_weight) if edge_weight is not None
         else np.ones(ei.shape[1], np.float32))
    rows_per = _round_up(-(-num_nodes // nparts), 8)
    owner_dst = np.minimum(ei[1] // rows_per, nparts - 1)
    owner_src = np.minimum(ei[0] // rows_per, nparts - 1)

    # Per consumer device p: its edges + intra-slice halo sets.
    # Per (producer slice s, consumer slice t): slice-deduped inter sets,
    # split by owner dp index d.
    part_edges = [None] * nparts
    halo_intra = [[np.empty(0, np.int64)] * D for _ in range(nparts)]
    inter = [[[np.empty(0, np.int64)] * D for _ in range(S)]
             for _ in range(S)]  # inter[s][t][d]
    inter_rows_flat = 0
    for t in range(S):
        slice_remote = [[] for _ in range(S)]  # global src ids, per producer
        for dc in range(D):
            p = t * D + dc
            mask = owner_dst == p
            sub = ei[:, mask]
            sub_owner = owner_src[mask]
            part_edges[p] = (sub, w[mask], sub_owner)
            for g in np.unique(sub_owner):
                g = int(g)
                s, d = g // D, g % D
                ids = np.unique(sub[0][sub_owner == g])
                if s == t:
                    if d != dc:
                        halo_intra[p][d] = ids
                else:
                    slice_remote[s].append(ids)
                    inter_rows_flat += len(ids)  # flat scheme: per device
        for s in range(S):
            if s == t or not slice_remote[s]:
                continue
            ids = np.unique(np.concatenate(slice_remote[s]))
            own = ids // rows_per % D  # dp index of the owner
            for d in range(D):
                inter[s][t][d] = ids[own == d]

    H1 = max([1] + [len(h) for hs in halo_intra for h in hs])
    H1 = _round_up(H1, 8)
    H2 = max([1] + [len(inter[s][t][d]) for s in range(S)
                    for t in range(S) for d in range(D)])
    H2 = _round_up(H2, 8)
    E_max = _round_up(max(1, max(pe[0].shape[1] for pe in part_edges)), 128)

    edge_out = np.zeros((S, D, 2, E_max), np.int32)
    w_out = np.zeros((S, D, E_max), np.float32)
    send_intra = np.zeros((S, D, D, H1), np.int32)
    send_inter = np.zeros((S, D, S, H2), np.int32)
    intra_rows = 0
    inter_rows = 0

    # sender-side tables
    for s in range(S):
        for t in range(S):
            if s == t:
                continue
            for d in range(D):
                ids = inter[s][t][d]
                inter_rows += len(ids)
                base = (s * D + d) * rows_per
                send_inter[s, d, t, :len(ids)] = ids - base

    inter_base = {}  # (s, t): searchsorted tables rebuilt per consumer edge
    for t in range(S):
        for dc in range(D):
            p = t * D + dc
            sub, sub_w, sub_owner = part_edges[p]
            E_p = sub.shape[1]
            src_local = np.empty(E_p, np.int64)
            for g in np.unique(sub_owner):
                g = int(g)
                s, d = g // D, g % D
                sel = sub_owner == g
                if g == p:
                    src_local[sel] = sub[0][sel] - g * rows_per
                elif s == t:
                    ids = halo_intra[p][d]
                    intra_rows += len(ids)
                    pos = np.searchsorted(ids, sub[0][sel])
                    src_local[sel] = rows_per + d * H1 + pos
                    # dp-peer d must send those rows to dc
                    send_intra[t, d, dc, :len(ids)] = ids - g * rows_per
                else:
                    ids = inter[s][t][d]
                    pos = np.searchsorted(ids, sub[0][sel])
                    src_local[sel] = (rows_per + D * H1
                                      + (d * S + s) * H2 + pos)
            dst_local = sub[1] - p * rows_per
            edge_out[t, dc, 0, :E_p] = src_local
            edge_out[t, dc, 1, :E_p] = dst_local
            edge_out[t, dc, 1, E_p:] = rows_per  # pads scatter-dropped
            w_out[t, dc, :E_p] = sub_w

    return HierHaloPartition(edge_out, w_out, send_intra, send_inter,
                             S, D, rows_per, H1, H2, num_nodes,
                             inter_rows, inter_rows_flat, intra_rows)


def make_hier_halo_spmm(mesh: Mesh, part: HierHaloPartition,
                        axes=("slice", "dp")):
    """Jit-able two-level halo SpMM over a ('slice','dp') mesh.

    x is (S*D*rows_per, F) sharded P(('slice','dp')) along the node dim;
    output keeps that sharding. Per device: intra-host all_to_all +
    inter-host all_to_all (dp coordinate fixed) + intra-host all_gather,
    then a local segment-sum into owned rows.
    """
    slice_ax, dp_ax = axes
    S, D = part.num_slices, part.dp_per_slice
    rows_per, H1, H2 = part.rows_per, part.h_intra, part.h_inter

    @partial(shard_map, mesh=mesh,
             in_specs=(P((slice_ax, dp_ax)), P(slice_ax, dp_ax),
                       P(slice_ax, dp_ax), P(slice_ax, dp_ax),
                       P(slice_ax, dp_ax)),
             out_specs=P((slice_ax, dp_ax)))
    def _spmm(x_blk, ei, w, s_intra, s_inter):
        # x_blk (rows_per, F); s_intra (1,1,D,H1); s_inter (1,1,S,H2)
        send1 = jnp.take(x_blk, s_intra.reshape(-1), axis=0, mode="clip")
        recv1 = lax.all_to_all(send1.reshape(D, H1, -1), dp_ax,
                               split_axis=0, concat_axis=0, tiled=False)
        send2 = jnp.take(x_blk, s_inter.reshape(-1), axis=0, mode="clip")
        recv2 = lax.all_to_all(send2.reshape(S, H2, -1), slice_ax,
                               split_axis=0, concat_axis=0, tiled=False)
        # recv2[s] = rows owned by (s, my_dp) that my slice needs; share
        # them within the slice -> table indexed [d_owner, s, pos]
        table2 = lax.all_gather(recv2, dp_ax, axis=0, tiled=False)
        table = jnp.concatenate(
            [x_blk, recv1.reshape(D * H1, -1),
             table2.reshape(D * S * H2, -1)], axis=0)
        src, dst = ei[0, 0, 0], ei[0, 0, 1]
        msg = jnp.take(table, src, axis=0, mode="clip") * w[0, 0][:, None]
        return segment_sum(msg, dst, rows_per)

    def run(x_sharded):
        return _spmm(x_sharded,
                     jnp.asarray(part.edge_index),
                     jnp.asarray(part.edge_weight),
                     jnp.asarray(part.send_intra),
                     jnp.asarray(part.send_inter))

    return run


def traffic_report(part: HierHaloPartition, feat_dim, dtype=jnp.bfloat16):
    """Per-layer boundary-traffic estimate, in bytes.

    ``inter_host_bytes_flat`` is what a single flat all_to_all over all
    S*D devices would move across the inter-host link (every
    consumer-device copy of a remote row crosses it);
    ``inter_host_bytes`` is this module's host-deduped volume.
    ``intra_host_bytes`` counts same-host halo rows plus the redistribute
    all_gather ((D-1)/D of the inter table is copied again within the
    host).
    """
    b = int(jnp.dtype(dtype).itemsize) * int(feat_dim)
    D = part.dp_per_slice
    inter = part.inter_rows * b
    inter_flat = part.inter_rows_flat * b
    intra = part.intra_rows * b + (D - 1) * part.inter_rows * b
    return {"inter_host_bytes": inter, "inter_host_bytes_flat": inter_flat,
            "dedup_factor": (part.inter_rows_flat
                             / max(1, part.inter_rows)),
            "intra_host_bytes": intra}
