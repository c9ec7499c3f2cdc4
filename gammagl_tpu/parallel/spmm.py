"""Sharded SpMM over a device mesh via shard_map.

Each device holds one edge shard ((2, E_shard) padded) and the full feature
matrix (replicated at this tier; the halo-exchange tier in
`gammagl_tpu.parallel.halo` shards features too). Local scatter-aggregate
runs on-chip; the partial sums are combined with `psum` over the edge axis --
XLA lowers this to an all-reduce.

This is net-new capability vs the reference (SURVEY.md section 2.10), built
the scaling-book way: annotate, shard_map, collectives.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from gammagl_tpu.ops import segment_sum

__all__ = ["sharded_spmm", "make_sharded_spmm"]


def make_sharded_spmm(mesh: Mesh, num_nodes: int, axis: str = "dp"):
    """Build a jit-able edge-sharded SpMM: (ei_shards, w_shards, x) -> (N, F).

    ei_shards: (P, 2, E_shard) int32 (padded dst = num_nodes -> dropped)
    w_shards:  (P, E_shard) float
    x:         (N, F) replicated
    """

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P()),
             out_specs=P())
    def _spmm(ei, w, x):
        # inside: ei (1, 2, E_shard) local block
        src, dst = ei[0, 0], ei[0, 1]
        msg = jnp.take(x, src, axis=0, mode="clip") * w[0][:, None]
        local = segment_sum(msg, dst, num_nodes)
        return jax.lax.psum(local, axis)

    return _spmm


def sharded_spmm(mesh, ei_shards, w_shards, x, num_nodes, axis="dp"):
    fn = make_sharded_spmm(mesh, num_nodes, axis)
    return fn(ei_shards, w_shards, x)
