"""MinCut pooling (reference: examples/citgnn/utils.py dense_mincut_pool;
Bianchi et al., "Spectral Clustering with Graph Neural Networks for Graph
Pooling").

Two entry points:

- ``dense_mincut_pool(x, adj, s)`` — the reference's dense formulation
  (N x N adjacency), kept for small graphs and parity tests.
- ``sparse_mincut_losses(s, edge_index, num_nodes, edge_weight)`` — the
  sparse path: both regularizers only need *traces* of S^T A S and
  S^T D S, which reduce to per-edge dot products (an SDDMM) and a
  degree-weighted row-norm sum — no N^2 adjacency ever materializes, so
  the mincut objective scales to graphs where the reference's
  ``adj.toarray()`` would not fit in HBM.
"""

import jax
import jax.numpy as jnp

from gammagl_tpu.ops.segment import segment_sum

__all__ = ["dense_mincut_pool", "sparse_mincut_losses"]

_EPS = 1e-10


def _mincut_losses_from_terms(mincut_num, mincut_den, ss, k):
    mincut_loss = -(mincut_num / (mincut_den + _EPS))
    i_s = jnp.eye(k, dtype=ss.dtype)
    ss_norm = ss / (jnp.sqrt(jnp.sum(ss ** 2)) + _EPS)
    i_s_norm = i_s / (jnp.sqrt(jnp.sum(i_s ** 2)) + _EPS)
    ortho_loss = jnp.sqrt(jnp.sum((ss_norm - i_s_norm) ** 2))
    return mincut_loss, ortho_loss


def dense_mincut_pool(x, adj, s, temp=1.0):
    """Reference-faithful dense mincut pool. ``s`` is pre-softmax logits
    (softmaxed here, like utils.py:114). Returns (pooled_x, pooled_adj,
    mincut_loss, ortho_loss)."""
    s = jax.nn.softmax(s / temp, axis=-1) if temp != 1.0 else (
        jax.nn.softmax(s, axis=-1))
    out = s.T @ x
    out_adj = s.T @ adj @ s
    mincut_num = jnp.trace(out_adj)
    d = jnp.sum(adj, axis=1)
    mincut_den = jnp.trace((s * d[:, None]).T @ s)
    mincut_loss, ortho_loss = _mincut_losses_from_terms(
        mincut_num, mincut_den, s.T @ s, s.shape[-1])
    return out, out_adj, mincut_loss, ortho_loss


def sparse_mincut_losses(s, edge_index, num_nodes, edge_weight=None,
                         temp=1.0):
    """Mincut + orthogonality losses from the edge list directly.

    trace(S^T A S) = sum_e w_e * (S[src_e] . S[dst_e])    (edge dot)
    trace(S^T D S) = sum_i d_i * ||S_i||^2                (row norms)

    ``s`` is pre-softmax cluster logits [N, k]. Identical math to
    ``dense_mincut_pool`` (asserted by tests/layers/test_mincut.py)."""
    s = jax.nn.softmax(s / temp, axis=-1) if temp != 1.0 else (
        jax.nn.softmax(s, axis=-1))
    src, dst = edge_index[0], edge_index[1]
    w = jnp.ones(src.shape[0], s.dtype) if edge_weight is None else (
        edge_weight.astype(s.dtype))
    mincut_num = jnp.sum(w * jnp.sum(s[src] * s[dst], axis=-1))
    # degree = adjacency ROW sums (einsum 'ijk->ij' in the reference), so
    # segment over src; identical to dst-degree on symmetric graphs
    deg = segment_sum(w, src, num_nodes)
    mincut_den = jnp.sum(deg * jnp.sum(s * s, axis=-1))
    return _mincut_losses_from_terms(mincut_num, mincut_den, s.T @ s,
                                     s.shape[-1])
