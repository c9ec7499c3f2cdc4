"""Self-supervised / contrastive models: DGI, GRACE, MVGRL, InfoGraph, GGD.

Reference: gammagl/models/{dgi,grace,mvgrl,infograph,ggd}.py.
"""

from typing import Optional, Tuple

from gammagl_tpu import nn
import jax
import jax.numpy as jnp

from gammagl_tpu.layers.conv import GCNConv
from gammagl_tpu.layers.pool import global_mean_pool, global_sum_pool

__all__ = ["DGIModel", "GraceModel", "MVGRLModel", "InfoGraph", "GGDModel",
           "grace_loss", "corrupt_features", "drop_edge_and_feature"]


def corrupt_features(rng, x):
    """Row-shuffle corruption (DGI negative samples)."""
    perm = jax.random.permutation(rng, x.shape[0])
    return x[perm]


def drop_edge_and_feature(rng, x, edge_index, feat_drop, edge_drop):
    """GRACE view augmentation: mask features, drop edges (as weights)."""
    k1, k2 = jax.random.split(rng)
    feat_mask = jax.random.bernoulli(k1, 1 - feat_drop, (1, x.shape[1]))
    x = x * feat_mask
    edge_mask = jax.random.bernoulli(k2, 1 - edge_drop,
                                     (edge_index.shape[1],))
    return x, edge_mask.astype(x.dtype)


class _GCNEncoder(nn.Module):
    hidden_dim: int
    num_layers: int = 1
    act: str = "prelu"

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None):
        for i in range(self.num_layers):
            x = GCNConv(self.hidden_dim)(x, edge_index, edge_weight,
                                         num_nodes)
            if self.act == "prelu":
                alpha = self.param(f"prelu_{i}", nn.initializers.constant(
                    0.25), (1,))
                x = jnp.where(x > 0, x, alpha * x)
            else:
                x = nn.relu(x)
        return x


class DGIModel(nn.Module):
    """Deep Graph Infomax (Velickovic 2019; reference dgi.py):
    local-global mutual information with a bilinear discriminator."""

    hidden_dim: int = 512

    @nn.compact
    def __call__(self, x, edge_index, x_corrupt=None, num_nodes=None):
        enc = _GCNEncoder(self.hidden_dim)
        h_pos = enc(x, edge_index, num_nodes=num_nodes)
        if x_corrupt is None:
            return h_pos
        h_neg = enc(x_corrupt, edge_index, num_nodes=num_nodes)
        summary = jax.nn.sigmoid(h_pos.mean(axis=0))
        w = self.param("disc", nn.initializers.glorot_uniform(),
                       (self.hidden_dim, self.hidden_dim))
        pos_score = h_pos @ (w @ summary)
        neg_score = h_neg @ (w @ summary)
        loss = -(jnp.mean(jax.nn.log_sigmoid(pos_score))
                 + jnp.mean(jax.nn.log_sigmoid(-neg_score)))
        return loss


def grace_loss(z1, z2, tau=0.5):
    """NT-Xent between two views (reference grace.py semi_loss)."""
    z1 = z1 / (jnp.linalg.norm(z1, axis=1, keepdims=True) + 1e-12)
    z2 = z2 / (jnp.linalg.norm(z2, axis=1, keepdims=True) + 1e-12)

    def semi(a, b):
        intra = jnp.exp(a @ a.T / tau)
        inter = jnp.exp(a @ b.T / tau)
        pos = jnp.diag(inter)
        denom = intra.sum(1) - jnp.diag(intra) + inter.sum(1)
        return -jnp.log(pos / denom)

    return 0.5 * (semi(z1, z2) + semi(z2, z1)).mean()


class GraceModel(nn.Module):
    """GRACE (Zhu 2020; reference grace.py): two augmented views + NT-Xent
    with a projection head."""

    hidden_dim: int = 128
    proj_dim: int = 128
    num_layers: int = 2
    tau: float = 0.5

    @nn.compact
    def __call__(self, x1, ei1, w1, x2=None, ei2=None, w2=None,
                 num_nodes=None):
        enc = _GCNEncoder(self.hidden_dim, self.num_layers, act="relu")
        z1 = enc(x1, ei1, w1, num_nodes)
        if x2 is None:
            return z1
        z2 = enc(x2, ei2, w2, num_nodes)
        proj = nn.Sequential([nn.Dense(self.proj_dim), nn.elu,
                              nn.Dense(self.hidden_dim)])
        return grace_loss(proj(z1), proj(z2), self.tau)


class MVGRLModel(nn.Module):
    """MVGRL (Hassani 2020; reference mvgrl.py): contrast adjacency view vs
    diffusion view with cross-view discriminators."""

    hidden_dim: int = 512

    @nn.compact
    def __call__(self, x, edge_index, diff_edge_index, diff_weight,
                 x_corrupt=None, num_nodes=None):
        enc_a = _GCNEncoder(self.hidden_dim)
        enc_d = _GCNEncoder(self.hidden_dim)
        h_a = enc_a(x, edge_index, num_nodes=num_nodes)
        h_d = enc_d(x, diff_edge_index, diff_weight, num_nodes=num_nodes)
        if x_corrupt is None:
            return h_a + h_d
        hn_a = enc_a(x_corrupt, edge_index, num_nodes=num_nodes)
        hn_d = enc_d(x_corrupt, diff_edge_index, diff_weight,
                     num_nodes=num_nodes)
        s_a = jax.nn.sigmoid(h_a.mean(0))
        s_d = jax.nn.sigmoid(h_d.mean(0))
        w = self.param("disc", nn.initializers.glorot_uniform(),
                       (self.hidden_dim, self.hidden_dim))
        # cross-view: local of one view vs summary of the other
        pos = (h_a @ (w @ s_d) + h_d @ (w @ s_a))
        neg = (hn_a @ (w @ s_d) + hn_d @ (w @ s_a))
        return -(jnp.mean(jax.nn.log_sigmoid(pos))
                 + jnp.mean(jax.nn.log_sigmoid(-neg)))


class InfoGraph(nn.Module):
    """InfoGraph (Sun 2020; reference infograph.py): graph-level embedding
    by node-graph mutual information over GIN layers."""

    hidden_dim: int = 32
    num_layers: int = 3

    @nn.compact
    def __call__(self, x, edge_index, batch, num_graphs, num_nodes=None):
        from gammagl_tpu.layers.conv import GINConv
        hs = []
        for i in range(self.num_layers):
            mlp = nn.Sequential([nn.Dense(self.hidden_dim), nn.relu,
                                 nn.Dense(self.hidden_dim), nn.relu])
            x = GINConv(apply_func=mlp)(x, edge_index, num_nodes=num_nodes)
            hs.append(x)
        h_node = jnp.concatenate(hs, axis=-1)
        h_graph = global_sum_pool(h_node, batch, num_graphs)
        # discriminator: node embedding vs its own graph (pos) / others (neg)
        proj_n = nn.Dense(self.hidden_dim)(h_node)
        proj_g = nn.Dense(self.hidden_dim)(h_graph)
        scores = proj_n @ proj_g.T  # (N, G)
        pos_mask = jax.nn.one_hot(batch, num_graphs)
        pos = (jax.nn.log_sigmoid(scores) * pos_mask).sum() / pos_mask.sum()
        neg_mask = 1 - pos_mask
        neg = (jax.nn.log_sigmoid(-scores) * neg_mask).sum() / jnp.maximum(
            neg_mask.sum(), 1)
        return -(pos + neg), h_graph


class GGDModel(nn.Module):
    """Graph Group Discrimination (Zheng 2022; reference ggd.py):
    binary discrimination of clean vs corrupted node groups."""

    hidden_dim: int = 512

    @nn.compact
    def __call__(self, x, edge_index, x_corrupt=None, num_nodes=None):
        enc = _GCNEncoder(self.hidden_dim)
        proj = nn.Dense(self.hidden_dim)
        h_pos = proj(enc(x, edge_index, num_nodes=num_nodes))
        if x_corrupt is None:
            return h_pos
        h_neg = proj(enc(x_corrupt, edge_index, num_nodes=num_nodes))
        pos_score = h_pos.sum(1)
        neg_score = h_neg.sum(1)
        return -(jnp.mean(jax.nn.log_sigmoid(pos_score))
                 + jnp.mean(jax.nn.log_sigmoid(-neg_score)))
