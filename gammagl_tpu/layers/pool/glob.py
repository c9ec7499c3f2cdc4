"""Global graph pooling (reference: gammagl/layers/pool/glob.py:5-117).

`batch` maps nodes to graphs; reductions are segment ops over it, so pooling
shares the same segment ops as message passing.
"""

import jax.numpy as jnp

from gammagl_tpu.ops.segment import (segment_max, segment_mean, segment_min,
                                     segment_sum)

__all__ = ["global_sum_pool", "global_add_pool", "global_mean_pool",
           "global_max_pool", "global_min_pool", "global_sort_pool"]


def _num_graphs(batch, num_graphs):
    if num_graphs is None:
        return int(batch.max()) + 1
    return num_graphs


def global_sum_pool(x, batch, num_graphs=None):
    if batch is None:
        return jnp.sum(x, axis=0, keepdims=True)
    return segment_sum(x, batch, _num_graphs(batch, num_graphs))


global_add_pool = global_sum_pool


def global_mean_pool(x, batch, num_graphs=None):
    if batch is None:
        return jnp.mean(x, axis=0, keepdims=True)
    return segment_mean(x, batch, _num_graphs(batch, num_graphs))


def global_max_pool(x, batch, num_graphs=None):
    if batch is None:
        return jnp.max(x, axis=0, keepdims=True)
    return segment_max(x, batch, _num_graphs(batch, num_graphs))


def global_min_pool(x, batch, num_graphs=None):
    if batch is None:
        return jnp.min(x, axis=0, keepdims=True)
    return segment_min(x, batch, _num_graphs(batch, num_graphs))


def global_sort_pool(x, batch, k, num_graphs=None):
    """Sort-pool (reference glob.py:117): sort nodes per graph by the last
    feature channel, keep top-k node feature rows, flatten.

    Implemented densely via to_dense_batch (static shapes for XLA).
    """
    from gammagl_tpu.utils.to_dense import to_dense_batch
    B = _num_graphs(batch, num_graphs) if batch is not None else 1
    dense, mask = to_dense_batch(x, batch, fill_value=-jnp.inf,
                                 batch_size=B)
    key = dense[..., -1]
    order = jnp.argsort(-key, axis=1)
    sorted_feats = jnp.take_along_axis(dense, order[..., None], axis=1)
    n = sorted_feats.shape[1]
    if n < k:
        pad = jnp.zeros((B, k - n, x.shape[-1]), x.dtype)
        sorted_feats = jnp.concatenate(
            [jnp.where(jnp.isneginf(sorted_feats), 0, sorted_feats), pad],
            axis=1)
    else:
        sorted_feats = jnp.where(jnp.isneginf(sorted_feats), 0,
                                 sorted_feats)[:, :k]
    return sorted_feats.reshape(B, k * x.shape[-1])
