"""RGT — Riemannian Graph Transformer over product manifolds.

Reference: gammagl/models/rgt.py (InitBlock:46, StructuralBlock:61,
VQBlock:96, RGT:185, loss:266, cal_cl_loss:291). Three parallel node
representations (Euclidean / hyperboloid / sphere) are refined by
structure-specific attention (BFS tree on H, cycles on S, BFS sequences on
E), exchanged through tangent projections, and vector-quantized; training is
self-supervised via commitment + cross-view InfoNCE losses.

Design notes: the reference sanitizes NaNs on the host after every block
(rgt.py:16-20,252-257) and falls back when the VQ output has NaNs
(rgt.py:172-180) — host syncs inside the step. Here the geometry clamps
(arccosh/arccos argument clipping in manifold_math) make those paths
unnecessary, and a single `jnp.nan_to_num` inside the traced function keeps
the step one XLA program. Structure subgraphs arrive as padded edge buffers
from `loader/rgt_loader.py` with static (num_seeds, max_edges) shapes, so
one compilation serves every batch.
"""

from gammagl_tpu import nn
import jax.numpy as jnp

from gammagl_tpu.layers.attention.rgt import (EuclideanStructureLearner,
                                              HyperbolicStructureLearner,
                                              SphericalStructureLearner)
from gammagl_tpu.layers.conv.rgt_layers import EuclideanEncoder, ManifoldEncoder
from gammagl_tpu.layers.conv.rgt_vq import VectorQuantizeE, VectorQuantizeR
from gammagl_tpu.utils.manifold_math import EuclideanM, LorentzM, SphereM

__all__ = ["RGTModel", "rgt_loss", "rgt_cl_loss"]


class InitBlock(nn.Module):
    """Token features -> (E, H, S) triple (reference rgt.py:46-58)."""

    manifold_H: object
    manifold_S: object
    in_dim: int
    hidden_dim: int
    out_dim: int
    dropout: float = 0.1

    @nn.compact
    def __call__(self, edge_index, tokens, deterministic=True):
        e = EuclideanEncoder(self.in_dim, self.hidden_dim, self.out_dim,
                             dropout=self.dropout,
                             name="euc_init")(tokens, deterministic)
        h = ManifoldEncoder(self.manifold_H, self.in_dim, self.hidden_dim,
                            self.out_dim, name="hyp_init")(tokens, edge_index)
        s = ManifoldEncoder(self.manifold_S, self.in_dim, self.hidden_dim,
                            self.out_dim, name="sph_init")(tokens, edge_index)
        return e, h, s


class StructuralBlock(nn.Module):
    """One RGT layer (reference rgt.py:61-93): structure learners per
    manifold, then tangent-space exchange back into the Euclidean stream."""

    manifold_H: object
    manifold_S: object
    manifold_E: object
    in_dim: int
    hidden_dim: int
    out_dim: int
    dropout: float = 0.1

    @nn.compact
    def __call__(self, x_E, x_H, x_S, tree_ei, cycle_ei, seq_ei, num_seeds,
                 deterministic=True):
        x_H = HyperbolicStructureLearner(
            self.manifold_H, self.manifold_S, self.in_dim, self.hidden_dim,
            self.out_dim, self.dropout, name="hyp_learner")(
            x_H, x_S, tree_ei, num_seeds, deterministic)
        x_S = SphericalStructureLearner(
            self.manifold_H, self.manifold_S, self.in_dim, self.hidden_dim,
            self.out_dim, self.dropout, name="sph_learner")(
            x_H, x_S, cycle_ei, num_seeds, deterministic)
        x_E = EuclideanStructureLearner(
            self.manifold_E, self.in_dim, self.hidden_dim, self.out_dim,
            self.dropout, name="euc_learner")(
            x_E, seq_ei, num_seeds, deterministic)

        h_e = self.manifold_H.transp0back(
            x_H, self.manifold_H.proju(x_H, x_E))
        s_e = self.manifold_S.transp0back(
            x_S, self.manifold_S.proju(x_S, x_E))
        e = jnp.concatenate([x_E, h_e, s_e], -1)
        e = nn.Dense(self.hidden_dim, name="proj_0")(e)
        e = nn.relu(e)
        x_E = nn.Dense(self.out_dim, name="proj_1")(e)
        x_E = x_E / jnp.sqrt(jnp.sum(x_E * x_E, -1, keepdims=True) + 1e-8)
        return x_E, x_H, x_S


class RGTModel(nn.Module):
    """Full RGT (reference rgt.py:185-264). `__call__` takes the padded
    batch produced by `ExtractNodeLoader` and returns the raw and quantized
    triples plus the summed commitment loss."""

    in_dim: int
    hidden_dim: int = 256
    embed_dim: int = 32
    n_layers: int = 3
    codebook_size: int = 256
    codebook_dim: int = 32
    codebook_heads: int = 8
    dropout: float = 0.1

    def setup(self):
        self.manifold_H = LorentzM()
        self.manifold_S = SphereM()
        self.manifold_E = EuclideanM()
        self.token_proj = nn.Dense(self.embed_dim, name="token_proj")
        self.init_block = InitBlock(self.manifold_H, self.manifold_S,
                                    self.embed_dim, self.hidden_dim,
                                    self.embed_dim, self.dropout)
        self.blocks = [
            StructuralBlock(self.manifold_H, self.manifold_S,
                            self.manifold_E, self.embed_dim, self.hidden_dim,
                            self.embed_dim, self.dropout,
                            name=f"block_{i}")
            for i in range(self.n_layers)]
        self.euc_vq = VectorQuantizeE(
            self.embed_dim, self.codebook_size, self.codebook_dim,
            self.codebook_heads)
        self.hyp_vq = VectorQuantizeR(
            self.manifold_H, self.embed_dim, self.codebook_size,
            self.codebook_dim, self.codebook_heads)
        self.sph_vq = VectorQuantizeR(
            self.manifold_S, self.embed_dim, self.codebook_size,
            self.codebook_dim, self.codebook_heads)
        self.cl_proj = nn.Sequential([
            nn.Dense(self.hidden_dim), nn.relu, nn.Dense(self.embed_dim)])

    def __call__(self, tokens, edge_index, tree_ei, cycle_ei, seq_ei,
                 num_seeds, deterministic=True):
        tokens = jnp.nan_to_num(self.token_proj(tokens))
        x_E, x_H, x_S = self.init_block(edge_index, tokens, deterministic)
        for block in self.blocks:
            x_E, x_H, x_S = block(x_E, x_H, x_S, tree_ei, cycle_ei, seq_ei,
                                  num_seeds, deterministic)
        q_E, ind_E, loss_E, _ = self.euc_vq(x_E)
        q_H, ind_H, loss_H, _ = self.hyp_vq(x_H)
        q_S, ind_S, loss_S, _ = self.sph_vq(x_S)
        return dict(x_E=x_E, x_H=x_H, x_S=x_S, q_E=q_E, q_H=q_H, q_S=q_S,
                    indices=(ind_E, ind_H, ind_S),
                    commit_loss=loss_E + loss_H + loss_S)

    def train_loss(self, tokens, edge_index, tree_ei, cycle_ei, seq_ei,
                   num_seeds, deterministic=True):
        """Forward + self-supervised loss in one traced function — use this
        as the `init`/`apply` method for training so every submodule
        (including the contrastive projector) is materialized."""
        out = self(tokens, edge_index, tree_ei, cycle_ei, seq_ei,
                   num_seeds, deterministic)
        return self.loss(out)

    def loss(self, out):
        """Commitment + cross-view InfoNCE (reference rgt.py:266-289).
        Returns (loss, fused_embedding)."""
        q_E, q_H, q_S = out["q_E"], out["q_H"], out["q_S"]
        h_e = self.manifold_H.transp0back(
            q_H, self.manifold_H.proju(q_H, q_E))
        s_e = self.manifold_S.transp0back(
            q_S, self.manifold_S.proju(q_S, q_E))
        e = (h_e + s_e) / 2.0
        log_h = self.manifold_H.logmap0(q_H)
        log_s = self.manifold_S.logmap0(q_S)
        h_e = self.cl_proj(jnp.concatenate([log_h, h_e], -1))
        s_e = self.cl_proj(jnp.concatenate([log_s, s_e], -1))
        loss = (out["commit_loss"]
                + 0.1 * rgt_cl_loss(h_e, s_e)
                + 0.1 * rgt_cl_loss(h_e, e)
                + 0.1 * rgt_cl_loss(s_e, e))
        return loss, jnp.concatenate([e, h_e, s_e], -1)


def rgt_cl_loss(x1, x2, tau=0.2, eps=1e-6):
    """Symmetric InfoNCE over cosine similarity (reference
    rgt.py:291-307)."""
    n1 = jnp.sqrt(jnp.sum(x1 * x1, -1, keepdims=True) + eps)
    n2 = jnp.sqrt(jnp.sum(x2 * x2, -1, keepdims=True) + eps)
    sim = jnp.exp((x1 @ x2.T) / (n1 @ n2.T + eps) / tau)
    pos = jnp.diagonal(sim)
    l1 = -jnp.mean(jnp.log(pos / (jnp.sum(sim, axis=0) + eps) + eps))
    l2 = -jnp.mean(jnp.log(pos / (jnp.sum(sim, axis=1) + eps) + eps))
    return (l1 + l2) / 2.0


def rgt_loss(model, params, batch, rngs=None):
    """Convenience: forward + self-supervised loss for one padded batch."""
    return model.apply(params, batch["tokens"], batch["edge_index"],
                       batch["tree_edge_index"], batch["cycle_edge_index"],
                       batch["seq_edge_index"], batch["num_seeds"],
                       method=RGTModel.train_loss, rngs=rngs)
