"""Partitioned graph attention: GAT-style layers over a halo partition.

Distributed attention is absent from the reference (single-device only,
SURVEY.md §2.10); this tier makes full-graph GAT training possible at
node counts that exceed one chip. The key structural fact: edges live
with their DESTINATION owner (halo partitioning), so the edge softmax —
a reduction over each destination's incoming edges — is purely local.
Only source features cross the wire, with the same one-per-layer
`all_to_all` as the planned SpMM tier.

Per device and layer:
  1. exchange halo rows of the (projected, multi-head) features;
  2. scores a_src·h_src + a_dst·h_dst over the device's dst-sorted edges,
     LeakyReLU, segment softmax over owned rows;
  3. alpha-weighted segment sum of the gathered source rows.

`make_partitioned_gat_layer` is the reusable layer. Padded edges point at
a dump row (`rows_per`) that is dropped, so they never reach numerators,
denominators or gradients.
"""

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from gammagl_tpu.parallel.halo import _halo_sets

__all__ = ["AttnHaloPartition", "build_halo_partition_attn",
           "make_partitioned_gat_layer"]


class AttnHaloPartition(NamedTuple):
    """Per-device edges over the combined [own | halo] source table.

    The softmax needs every incoming edge's score before any aggregation,
    so the exchange is on the critical path; per-edge attention weights
    are computed each step.
    """
    send_idx: np.ndarray   # (P, P, H) local rows each owner sends a peer
    src_local: np.ndarray  # (P, E_max) into the combined table
    dst_local: np.ndarray  # (P, E_max) owned dst row, pads -> rows_per
    num_parts: int
    rows_per: int
    halo_per_peer: int
    num_nodes: int


def build_halo_partition_attn(edge_index, num_nodes, num_parts):
    """Halo partition for attention layers: each device's incoming edges,
    sorted by destination and padded to one length."""
    rows_per, H, part_edges, halo, send_idx = _halo_sets(
        edge_index, num_nodes, num_parts)
    srcs, dsts = [], []
    for p in range(num_parts):
        sub, _, src_owner = part_edges[p]
        dst_local = sub[1] - p * rows_per
        src_local = np.empty(sub.shape[1], np.int64)
        own = src_owner == p
        src_local[own] = sub[0][own] - p * rows_per
        for q in range(num_parts):
            if q == p:
                continue
            sel = src_owner == q
            if sel.any():
                pos = np.searchsorted(halo[p][q], sub[0][sel])
                src_local[sel] = rows_per + q * H + pos
        order = np.argsort(dst_local, kind="stable")
        srcs.append(src_local[order])
        dsts.append(dst_local[order])
    e_max = max(1, max(len(d) for d in dsts))
    src_pad = np.stack([np.pad(s_, (0, e_max - len(s_))) for s_ in srcs])
    dst_pad = np.stack([np.pad(d, (0, e_max - len(d)),
                               constant_values=rows_per) for d in dsts])
    return AttnHaloPartition(
        send_idx=send_idx, src_local=src_pad.astype(np.int32),
        dst_local=dst_pad.astype(np.int32), num_parts=num_parts,
        rows_per=rows_per, halo_per_peer=H, num_nodes=num_nodes)


def make_partitioned_gat_layer(mesh: Mesh, part: AttnHaloPartition,
                               num_heads, axis: str = "dp",
                               negative_slope: float = 0.2):
    """GAT attention layer over the partition (reference semantics:
    gammagl/layers/conv/gat_conv.py:7 — score LeakyReLU(a_src·h_s +
    a_dst·h_d), edge softmax per destination, weighted aggregation).

    Returns `layer(h_sharded, a_src, a_dst) -> out_sharded` where
    `h_sharded` is the PROJECTED feature matrix (P*rows_per, H*Fh)
    sharded P(axis) (project with a plain sharded matmul first — GSPMD
    keeps it local), `a_src`/`a_dst` are (H, Fh) attention vectors.
    Output is (P*rows_per, H*Fh), mean/concat and bias are the caller's.
    Differentiable in all three arguments.
    """
    rows_per, Hh, nparts = part.rows_per, part.halo_per_peer, part.num_parts
    heads = int(num_heads)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis),) * 4 + (P(), P()),
             out_specs=P(axis), check_vma=False)
    def _layer(h_blk, send_idx, src_local, dst_local, a_src, a_dst):
        F = h_blk.shape[1]
        Fh = F // heads
        send = jnp.take(h_blk, send_idx[0].reshape(-1), axis=0,
                        mode="clip").reshape(nparts, Hh, -1)
        recv = jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0,
                                  tiled=False)
        table = jnp.concatenate([h_blk, recv.reshape(nparts * Hh, -1)], 0)
        t3 = table.reshape(-1, heads, Fh)
        # per-node score halves (f32 for a stable softmax)
        as_n = jnp.einsum("lhf,hf->lh", t3.astype(jnp.float32),
                          a_src.astype(jnp.float32))
        ad_n = jnp.einsum("lhf,hf->lh", t3[:rows_per].astype(jnp.float32),
                          a_dst.astype(jnp.float32))
        src, rows = src_local[0], dst_local[0]
        def seg(v):
            return jax.ops.segment_sum(v, rows, rows_per + 1,
                                       indices_are_sorted=True)

        e = jnp.take(as_n, src, axis=0, mode="clip") \
            + jnp.take(jnp.pad(ad_n, ((0, 1), (0, 0))), rows, axis=0)
        e = jax.nn.leaky_relu(e, negative_slope)          # (E, H)
        e = jnp.where(rows[:, None] < rows_per, e, -jnp.inf)
        m = jax.ops.segment_max(e, rows, rows_per + 1,
                                indices_are_sorted=True)
        m = jnp.where(jnp.isfinite(m), m, 0.0)            # empty rows
        ex = jnp.where(rows[:, None] < rows_per,
                       jnp.exp(e - jnp.take(m, rows, axis=0)), 0.0)
        alpha = ex / jnp.take(jnp.maximum(seg(ex), 1e-16), rows, axis=0)
        msg = jnp.take(t3, src, axis=0, mode="clip")       # (E, H, Fh)
        out = seg(msg * alpha[..., None].astype(msg.dtype))
        return out[:rows_per].reshape(rows_per, F)

    consts = [np.asarray(a) for a in
              (part.send_idx, part.src_local, part.dst_local)]

    def layer(h_sharded, a_src, a_dst):
        return _layer(h_sharded, *consts, a_src, a_dst)

    return layer
