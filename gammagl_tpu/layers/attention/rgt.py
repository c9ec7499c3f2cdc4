"""RGT cross-manifold structure learners.

Reference: gammagl/layers/attention/rgt_attention.py:17-205
(HyperbolicStructureLearner:17, SphericalStructureLearner:51,
EuclideanStructureLearner:89, CrossManifoldAttention:122,
EuclideanAttention:169).

Re-design. The reference compacts source ids with host-side
`np.unique(..., return_inverse=True)` before the edge softmax
(rgt_attention.py:152-154) — a device->host sync per layer per batch. Segment
softmax is invariant to relabeling segments, so here the softmax runs directly
over the tiled node id space with a *static* segment count
(num_seeds * num_nodes): one fused XLA region, no syncs, jit-stable shapes.
Structure subgraph edge buffers are expected zero-padded with id
`num_segments` (masked out by segment_softmax / segment_sum).
"""

from gammagl_tpu import nn
import jax.numpy as jnp

from gammagl_tpu.layers.conv.rgt_layers import ConstCurveLinear
from gammagl_tpu.ops.segment import unsorted_segment_sum
from gammagl_tpu.ops.softmax import segment_softmax

__all__ = ["CrossManifoldAttention", "EuclideanAttention",
           "HyperbolicStructureLearner", "SphericalStructureLearner",
           "EuclideanStructureLearner"]

_EPS = 1e-8


class CrossManifoldAttention(nn.Module):
    """Queries on one manifold attend over keys/values on another
    (reference rgt_attention.py:122-166): per-edge LeakyReLU score of the
    concatenated (q_src, k_dst) pair, softmax per source node, weighted
    segment sum, then renormalization onto the key manifold."""

    manifold_q: object
    manifold_k: object
    in_dim: int
    hidden_dim: int
    out_dim: int
    dropout: float = 0.1

    @nn.compact
    def __call__(self, x_q, x_k, x_v, edge_index, deterministic=True):
        q = ConstCurveLinear(self.manifold_q, self.in_dim, self.hidden_dim,
                             bias=False, dropout=self.dropout,
                             name="q_lin")(x_q, deterministic)
        k = ConstCurveLinear(self.manifold_k, self.in_dim, self.hidden_dim,
                             bias=False, dropout=self.dropout,
                             name="k_lin")(x_k, deterministic)
        v = ConstCurveLinear(self.manifold_k, self.in_dim, self.hidden_dim,
                             bias=False, dropout=self.dropout,
                             name="v_lin")(x_v, deterministic)
        src, dst = edge_index[0], edge_index[1]
        num_nodes = q.shape[0]

        qk = jnp.concatenate([q[src], k[dst]], -1)
        score = nn.leaky_relu(
            nn.Dense(1, use_bias=False, name="scalar_map")(qk), 0.2)[..., 0]
        score = segment_softmax(score, src, num_nodes)
        out = unsorted_segment_sum(score[:, None] * v[dst], src, num_nodes)

        denorm = jnp.sqrt(jnp.maximum(
            jnp.abs(self.manifold_k.inner(None, out, keepdim=True)), _EPS))
        out = out / (jnp.sqrt(self.manifold_k.k) * denorm)
        return ConstCurveLinear(self.manifold_k, self.hidden_dim,
                                self.out_dim, bias=False,
                                dropout=self.dropout,
                                name="proj")(out, deterministic)


class EuclideanAttention(nn.Module):
    """Flat-space variant (reference rgt_attention.py:169-205) with
    L2-normalized output."""

    in_dim: int
    hidden_dim: int
    out_dim: int
    dropout: float = 0.1

    @nn.compact
    def __call__(self, x_q, x_k, x_v, edge_index, deterministic=True):
        q = nn.Dense(self.hidden_dim, use_bias=False, name="q_lin")(x_q)
        k = nn.Dense(self.hidden_dim, use_bias=False, name="k_lin")(x_k)
        v = nn.Dense(self.hidden_dim, use_bias=False, name="v_lin")(x_v)
        src, dst = edge_index[0], edge_index[1]
        num_nodes = q.shape[0]

        qk = jnp.concatenate([q[src], k[dst]], -1)
        score = nn.leaky_relu(
            nn.Dense(1, use_bias=False, name="scalar_map")(qk), 0.2)[..., 0]
        score = segment_softmax(score, src, num_nodes)
        out = unsorted_segment_sum(score[:, None] * v[dst], src, num_nodes)
        out = nn.Dense(self.out_dim, use_bias=False, name="proj")(out)
        if self.dropout > 0.0 and not deterministic:
            out = nn.Dropout(self.dropout, deterministic=False)(out)
        return out / jnp.sqrt(jnp.sum(out * out, -1, keepdims=True) + _EPS)


def _tiled_structure_agg(manifold, agg_out, x, num_seeds):
    """Frechet-mean the `num_seeds` attended copies of each node together
    with the original (reference rgt_attention.py:41-47): labels are
    tile(arange(N), S) ++ arange(N), all static shapes."""
    n = x.shape[0]
    labels = jnp.concatenate(
        [jnp.tile(jnp.arange(n, dtype=jnp.int32), num_seeds),
         jnp.arange(n, dtype=jnp.int32)])
    stacked = jnp.concatenate([agg_out, x], axis=0)
    return manifold.frechet_mean(stacked, labels, n)


class HyperbolicStructureLearner(nn.Module):
    """BFS-tree local attention on the hyperboloid, with spherical queries
    (reference rgt_attention.py:17-48). `tree_edge_index` addresses the
    tiled (num_seeds * N) node space and is zero-padded with id
    num_seeds*N."""

    manifold_H: object
    manifold_S: object
    in_dim: int
    hidden_dim: int
    out_dim: int
    dropout: float = 0.1

    @nn.compact
    def __call__(self, x_H, x_S, tree_edge_index, num_seeds,
                 deterministic=True):
        n = x_H.shape[0]
        tiled = jnp.tile(jnp.arange(n, dtype=jnp.int32), num_seeds)
        x = CrossManifoldAttention(
            self.manifold_S, self.manifold_H, self.in_dim, self.hidden_dim,
            self.out_dim, self.dropout, name="tree_agg")(
            x_S[tiled], x_H[tiled], x_H[tiled], tree_edge_index,
            deterministic)
        return _tiled_structure_agg(self.manifold_H, x, x_H, num_seeds)


class SphericalStructureLearner(nn.Module):
    """Cycle-subgraph attention on the sphere, with hyperbolic queries
    (reference rgt_attention.py:51-86)."""

    manifold_H: object
    manifold_S: object
    in_dim: int
    hidden_dim: int
    out_dim: int
    dropout: float = 0.1

    @nn.compact
    def __call__(self, x_H, x_S, cycle_edge_index, num_seeds,
                 deterministic=True):
        n = x_S.shape[0]
        tiled = jnp.tile(jnp.arange(n, dtype=jnp.int32), num_seeds)
        x = CrossManifoldAttention(
            self.manifold_H, self.manifold_S, self.in_dim, self.hidden_dim,
            self.out_dim, self.dropout, name="cycle_agg")(
            x_H[tiled], x_S[tiled], x_S[tiled], cycle_edge_index,
            deterministic)
        return _tiled_structure_agg(self.manifold_S, x, x_S, num_seeds)


class EuclideanStructureLearner(nn.Module):
    """BFS-sequence attention in flat space (reference
    rgt_attention.py:89-120)."""

    manifold_E: object
    in_dim: int
    hidden_dim: int
    out_dim: int
    dropout: float = 0.1

    @nn.compact
    def __call__(self, x_E, seq_edge_index, num_seeds, deterministic=True):
        n = x_E.shape[0]
        tiled = jnp.tile(jnp.arange(n, dtype=jnp.int32), num_seeds)
        x = EuclideanAttention(
            self.in_dim, self.hidden_dim, self.out_dim, self.dropout,
            name="sequence_agg")(
            x_E[tiled], x_E[tiled], x_E[tiled], seq_edge_index,
            deterministic)
        return _tiled_structure_agg(self.manifold_E, x, x_E, num_seeds)
