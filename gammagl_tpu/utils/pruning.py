"""Magnitude pruning utilities (UniFews).

Reference: gammagl/gglspeedup/prunes_gamma.py (`ThrInPrune`, `rewind`,
`prune`) and the unifews conv variants (gammagl/layers/conv/
gcn_unifews.py:16-22): entry-wise thresholding of weights and of
message/edge contributions. Here pruning is realized as masking (XLA has
no sparsity win for irregular masks, but the capability -- accuracy under
operator sparsification -- is preserved and measurable).
"""

from typing import Any, Dict

import jax
import jax.numpy as jnp

__all__ = ["threshold_prune", "prune_params", "rewind", "sparsity",
           "prune_edges_by_weight"]


def threshold_prune(x, thr):
    """Zero entries with |x| < thr; returns (pruned, mask)."""
    mask = jnp.abs(x) >= thr
    return x * mask, mask


def prune_params(params, thr):
    """Apply threshold pruning to every weight leaf; returns (params,
    masks)."""
    leaves = {}

    def f(p):
        return threshold_prune(p, thr)

    pruned = jax.tree_util.tree_map(lambda p: f(p)[0], params)
    masks = jax.tree_util.tree_map(lambda p: f(p)[1], params)
    return pruned, masks


def rewind(params, init_params, masks):
    """Lottery-ticket rewind: reset surviving weights to their init values
    (reference prunes_gamma.rewind)."""
    return jax.tree_util.tree_map(
        lambda init, m: init * m, init_params, masks)


def sparsity(masks):
    """Fraction of zeros across all mask leaves."""
    total = sum(m.size for m in jax.tree_util.tree_leaves(masks))
    nnz = sum(int(m.sum()) for m in jax.tree_util.tree_leaves(masks))
    return 1.0 - nnz / max(total, 1)


def prune_edges_by_weight(edge_weight, thr):
    """UniFews message pruning: edges with |w| < thr become exact no-ops
    (weight 0 -> dropped by every reduction)."""
    return jnp.where(jnp.abs(edge_weight) >= thr, edge_weight, 0.0)
