"""Shallow embedding models: DeepWalk, Node2Vec, MetaPath2Vec.

Reference: gammagl/models/{deepwalk,node2vec,metapath2vec}.py (node2vec.py:12
with pos_sample:88 / neg_sample:99). Walk generation is host-side
(`gammagl_tpu.loader.random_walk` / the C++ core); the skip-gram objective
runs on-device.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
from gammagl_tpu import nn
import jax
import jax.numpy as jnp

__all__ = ["DeepWalk", "Node2Vec", "MetaPath2Vec"]


def _skipgram_loss(emb, pos_walks, neg_walks, context_size):
    """Negative-sampling skip-gram over walk windows.

    pos_walks: (B, L) node ids; neg_walks: (B, K, L).
    """
    def window_loss(walks, sign):
        # score between walk start (center) and each context position
        center = emb[walks[:, :1]]                     # (B, 1, D)
        context = emb[walks[:, 1:context_size]]        # (B, C-1, D)
        logits = jnp.sum(center * context, axis=-1)
        return -jnp.mean(jax.nn.log_sigmoid(sign * logits))

    pos = window_loss(pos_walks, 1.0)
    neg = window_loss(neg_walks.reshape(-1, neg_walks.shape[-1]), -1.0)
    return pos + neg


class Node2Vec(nn.Module):
    """Biased-walk skip-gram embeddings (Grover & Leskovec 2016)."""

    num_nodes: int
    embedding_dim: int = 128
    walk_length: int = 10
    context_size: int = 5
    p: float = 1.0
    q: float = 1.0
    num_negatives: int = 1

    @nn.compact
    def __call__(self, pos_walks=None, neg_walks=None):
        emb = self.param("embedding",
                         nn.initializers.normal(1.0 / self.embedding_dim),
                         (self.num_nodes, self.embedding_dim))
        if pos_walks is None:
            return emb
        return _skipgram_loss(emb, pos_walks, neg_walks, self.context_size)

    def campaign(self):  # pragma: no cover - convenience alias
        return None

    def make_loader(self, edge_index, batch_size=128, seed=None):
        """Host-side walk loader matching this model's hyperparameters."""
        from gammagl_tpu.loader.random_walk import RandomWalkLoader
        return RandomWalkLoader(edge_index, self.num_nodes,
                                batch_size=batch_size,
                                walk_length=self.walk_length,
                                num_negatives=self.num_negatives,
                                p=self.p, q=self.q, seed=seed)


class DeepWalk(Node2Vec):
    """Uniform-walk special case (p = q = 1), reference deepwalk.py."""

    p: float = 1.0
    q: float = 1.0


class MetaPath2Vec(nn.Module):
    """Metapath-guided walks on a HeteroGraph (Dong 2017;
    reference metapath2vec.py:14). Embeddings are stored in one table over
    the concatenated per-type id space.
    """

    num_nodes_dict: Dict[str, int]
    metapath: Tuple[Tuple[str, str, str], ...]
    embedding_dim: int = 128
    walk_length: int = 10
    context_size: int = 5
    num_negatives: int = 1

    @property
    def offsets(self):
        out, cursor = {}, 0
        for nt, n in sorted(self.num_nodes_dict.items()):
            out[nt] = cursor
            cursor += n
        return out

    @property
    def total_nodes(self):
        return sum(self.num_nodes_dict.values())

    def setup(self):
        self.embedding = self.param(
            "embedding", nn.initializers.normal(1.0 / self.embedding_dim),
            (self.total_nodes, self.embedding_dim))

    def __call__(self, pos_walks=None, neg_walks=None):
        if pos_walks is None:
            return self.embedding
        return _skipgram_loss(self.embedding, pos_walks, neg_walks,
                              self.context_size)

    def embed(self, node_type, ids=None):
        emb = self.embedding
        lo = self.offsets[node_type]
        n = self.num_nodes_dict[node_type]
        block = emb[lo:lo + n]
        return block if ids is None else block[ids]

    def sample_walks(self, edge_index_dict, batch_starts, rng=None):
        """Host-side metapath walk: follow the edge types of `metapath`
        cyclically for walk_length steps. Returns global-id walks."""
        rng = rng or np.random.default_rng()
        from gammagl_tpu.ops.sparse import ind2ptr_np
        csr = {}
        for et, ei in edge_index_dict.items():
            ei = np.asarray(ei)
            order = np.argsort(ei[0], kind="stable")
            n_src = self.num_nodes_dict[et[0]]
            csr[et] = (ind2ptr_np(ei[0][order], n_src), ei[1][order])
        start_type = self.metapath[0][0]
        walks = np.empty((len(batch_starts), self.walk_length + 1),
                         np.int64)
        for i, s in enumerate(np.asarray(batch_starts)):
            cur, cur_t = int(s), start_type
            walks[i, 0] = cur + self.offsets[cur_t]
            for t in range(1, self.walk_length + 1):
                et = self.metapath[(t - 1) % len(self.metapath)]
                rowptr, col = csr[et]
                lo, hi = rowptr[cur], rowptr[cur + 1]
                if hi > lo:
                    cur = int(col[rng.integers(lo, hi)])
                    cur_t = et[2]
                walks[i, t] = cur + self.offsets[cur_t]
        return walks
