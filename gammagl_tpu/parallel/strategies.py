"""Additional parallel strategies: pipeline (pp), feature-sharded (sp),
and relation-expert (ep) execution.

The reference has NO distributed execution (SURVEY.md section 2.10) — these
are net-new components expressed with `shard_map` over a named
mesh, XLA collectives only (`ppermute`, `psum`):

- `pipeline_apply` — GPipe over layers: stage s (one mesh slot along the
  'pp' axis) owns layer s's weights; microbatches of node blocks stream
  stage-to-stage via `ppermute` with the classic (num_micro + num_stages
  - 1)-step schedule.
- `make_feature_sharded_spmm` — sequence-parallel analog: the feature
  dimension is sharded over 'sp'; SpMM is independent per feature column so
  the aggregation runs with ZERO collectives (the dense mixing layers pay
  one psum instead).
- `relation_expert_spmm` — expert-parallel analog for relational models
  (RGCN/HGT): each device owns a subset of relation weight matrices
  (experts); edges are masked to the local relations and partial
  destination sums are combined with one psum over 'ep'.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gammagl_tpu.ops.segment import segment_sum

__all__ = ["pipeline_apply", "make_pipeline_apply",
           "make_feature_sharded_spmm",
           "relation_expert_spmm", "make_relation_expert_spmm",
           "shard_pipeline_params", "shard_expert_weights"]


def shard_pipeline_params(mesh, stage_params, axis="pp"):
    """Place per-stage parameter slices on their pipeline stages (leaves
    have leading dim = num_stages)."""
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P(axis))),
        stage_params)


def make_pipeline_apply(mesh, stage_fn, num_micro, axis="pp"):
    """Build the differentiable GPipe forward: returns
    ``run(params_sharded, x_micro) -> (num_micro, B, F)``.

    The returned function is pure (no device placement inside), so it
    composes with `jax.jit` / `jax.value_and_grad` — backward streams
    activation cotangents stage-to-stage through the transposed
    `ppermute`s, the standard GPipe backward schedule."""
    num_stages = mesh.shape[axis]
    steps = num_micro + num_stages - 1

    @partial(shard_map, mesh=mesh, in_specs=(P(axis), P()),
             out_specs=P(), check_vma=False)
    def run(params, xm):
        stage = jax.lax.axis_index(axis)
        p_local = jax.tree_util.tree_map(lambda a: a[0], params)
        buf = jnp.zeros_like(xm[0])          # activation held by this stage
        outs = jnp.zeros_like(xm)

        def step(carry, t):
            buf, outs = carry
            # stage 0 ingests microbatch t (when in range)
            feed = jnp.where(t < num_micro, t, num_micro - 1)
            inject = xm[feed]
            h = jnp.where(stage == 0, inject, buf)
            h = stage_fn(p_local, h)
            # completed microbatch index leaving the last stage
            done = t - (num_stages - 1)
            outs = jax.lax.cond(
                (stage == num_stages - 1) & (done >= 0) & (done < num_micro),
                lambda o: o.at[jnp.clip(done, 0, num_micro - 1)].set(h),
                lambda o: o, outs)
            # stream activations downstream
            perm = [(i, (i + 1) % num_stages) for i in range(num_stages)]
            buf = jax.lax.ppermute(h, axis, perm)
            return (buf, outs), ()

        (buf, outs), _ = jax.lax.scan(step, (buf, outs),
                                      jnp.arange(steps))
        # every stage computed `outs`, but only the last stage's is real:
        # broadcast it (psum of the masked copy)
        mine = jnp.where(stage == num_stages - 1, 1.0, 0.0)
        return jax.lax.psum(outs * mine, axis)

    return run


def pipeline_apply(mesh, stage_fn, stage_params, x_micro, axis="pp"):
    """GPipe-style pipelined forward (one-shot convenience wrapper over
    `make_pipeline_apply`; for training, build once and differentiate).

    Parameters
    ----------
    stage_fn : (params_s, h) -> h, the per-stage computation (same shape
        in/out so activations stream stage-to-stage)
    stage_params : pytree whose leaves have leading dim = num_stages
        (stage s's slice lives on mesh slot s along `axis`)
    x_micro : (num_micro, B, F) microbatches
    Returns (num_micro, B, F) outputs from the last stage.
    """
    params_sharded = shard_pipeline_params(mesh, stage_params, axis)
    x_sharded = jax.device_put(x_micro, NamedSharding(mesh, P()))
    run = make_pipeline_apply(mesh, stage_fn, x_micro.shape[0], axis)
    return run(params_sharded, x_sharded)


def make_feature_sharded_spmm(mesh, num_nodes, axis="sp"):
    """SpMM with the FEATURE dimension sharded over `axis` (sequence-
    parallel analog). Aggregation needs no collectives; callers pay one
    psum only inside sharded dense layers."""

    @partial(shard_map, mesh=mesh, in_specs=(P(), P(), P(None, axis)),
             out_specs=P(None, axis), check_vma=False)
    def run(ei, w, x_shard):
        src, dst = ei[0], ei[1]
        msg = jnp.take(x_shard, src, axis=0, mode="clip")
        if w is not None:
            msg = msg * w[:, None]
        return segment_sum(msg, dst, num_nodes)

    return run


def shard_expert_weights(mesh, weights, axis="ep"):
    """Pad relation weights (num_rel, F_in, F_out) to a multiple of the
    expert-axis size and place expert blocks on their owners. Returns the
    sharded (ndev, per, F_in, F_out) array."""
    ndev = mesh.shape[axis]
    num_rel = weights.shape[0]
    per = -(-num_rel // ndev)
    pad = per * ndev - num_rel
    if pad:
        weights = jnp.pad(weights, ((0, pad), (0, 0), (0, 0)))
    return jax.device_put(
        weights.reshape(ndev, per, *weights.shape[1:]),
        NamedSharding(mesh, P(axis)))


def make_relation_expert_spmm(mesh, num_nodes, axis="ep"):
    """Build the differentiable expert-parallel relational SpMM:
    ``run(ei, et, x, w_sharded) -> (num_nodes, F_out)`` with
    ``w_sharded`` from `shard_expert_weights`. Pure — composes with
    `jax.value_and_grad` wrt both x and the expert weights (the forward
    psum transposes to an identity broadcast; each expert's weight grad
    stays local to its owner)."""
    ndev = mesh.shape[axis]

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P(), P(axis)), out_specs=P(),
             check_vma=False)
    def run(ei, et, x, w_local):
        dev = jax.lax.axis_index(axis)
        per = w_local.shape[1]
        w_local = w_local[0]                     # (per, F_in, F_out)
        src, dst = ei[0], ei[1]
        local_rel = et - dev * per               # [0, per) when ours
        ours = (local_rel >= 0) & (local_rel < per)
        rel_c = jnp.clip(local_rel, 0, per - 1)
        # per-edge transform with the owning expert's matrix: gather the
        # (F_in, F_out) expert per edge and contract -- one batched contraction
        xe = jnp.take(x, src, axis=0, mode="clip")
        we = jnp.take(w_local, rel_c, axis=0)
        msg = jnp.einsum("ef,efo->eo", xe, we)
        msg = jnp.where(ours[:, None], msg, 0.0)
        return jax.lax.psum(segment_sum(msg, dst, num_nodes), axis)

    return run


def relation_expert_spmm(mesh, edge_index, edge_type, x, weights,
                         num_nodes, axis="ep"):
    """Relation-typed transform + aggregate with relation weights sharded
    over `axis` (expert parallelism for RGCN-style models). One-shot
    wrapper over `make_relation_expert_spmm` + `shard_expert_weights`;
    weights: (num_relations, F_in, F_out), relation r owned by device
    r // ceil(num_rel / ndev).
    """
    w_sharded = shard_expert_weights(mesh, jnp.asarray(weights), axis)
    run = make_relation_expert_spmm(mesh, num_nodes, axis)
    return run(jnp.asarray(edge_index), jnp.asarray(edge_type),
               jnp.asarray(x), w_sharded)
