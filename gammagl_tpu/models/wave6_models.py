"""Wave-6 models: MAGCL, GCIL, SFGCN, EdgePrompt, AMP, DFAD-GNN.

Reference: gammagl/models/{magcl,gcil,sfgcn,edgeprompt,amp,dfad_gnn}.py.
"""

from typing import Sequence

import numpy as np
from gammagl_tpu import nn
import jax
import jax.numpy as jnp
import optax

from gammagl_tpu.layers.conv import GCNConv
from gammagl_tpu.models.ssl import _GCNEncoder, grace_loss

__all__ = ["MAGCLModel", "GCILModel", "SFGCNModel", "EdgePromptModel",
           "AMPModel", "dfad_generator_loss", "dfad_student_loss"]


class MAGCLModel(nn.Module):
    """MA-GCL / "NewGrace" (reference magcl.py): GRACE with model
    augmentation -- the two views run the shared encoder with different
    propagation depths instead of (only) data augmentation."""

    hidden_dim: int = 128
    tau: float = 0.5
    k_low: int = 1
    k_high: int = 3

    @nn.compact
    def __call__(self, x1, ei1, w1, x2=None, ei2=None, w2=None,
                 num_nodes=None):
        enc_low = _GCNEncoder(self.hidden_dim, self.k_low, act="relu")
        enc_high = _GCNEncoder(self.hidden_dim, self.k_high, act="relu")
        z1 = enc_low(x1, ei1, w1, num_nodes)
        if x2 is None:
            return z1
        z2 = enc_high(x2, ei2, w2, num_nodes)
        proj = nn.Sequential([nn.Dense(self.hidden_dim), nn.elu,
                              nn.Dense(self.hidden_dim)])
        return grace_loss(proj(z1), proj(z2), self.tau)


class GCILModel(nn.Module):
    """GCIL (Mo 2024; reference gcil.py): invariance + decorrelation
    objective (Barlow-Twins style cross-correlation) over two augmented
    views."""

    hidden_dim: int = 128
    lambd: float = 5e-3

    @nn.compact
    def __call__(self, x1, ei1, w1, x2=None, ei2=None, w2=None,
                 num_nodes=None):
        enc = _GCNEncoder(self.hidden_dim, 2, act="relu")
        z1 = enc(x1, ei1, w1, num_nodes)
        if x2 is None:
            return z1
        z2 = enc(x2, ei2, w2, num_nodes)

        def norm(z):
            return (z - z.mean(0)) / (z.std(0) + 1e-6)

        n = z1.shape[0]
        c = norm(z1).T @ norm(z2) / n  # (D, D) cross-correlation
        on_diag = ((jnp.diag(c) - 1) ** 2).sum()
        off_diag = (c ** 2).sum() - (jnp.diag(c) ** 2).sum()
        return on_diag + self.lambd * off_diag


class SFGCNModel(nn.Module):
    """SFGCN / AM-GCN-style structure-feature fusion (reference sfgcn.py):
    parallel GCNs over the topology graph and a kNN feature graph + a
    common encoder, fused by per-node attention; consistency regularizer
    returned alongside logits."""

    num_class: int
    hidden_dim: int = 64

    @nn.compact
    def __call__(self, x, edge_index, feat_edge_index, num_nodes=None,
                 train=False):
        h_t = nn.relu(GCNConv(self.hidden_dim, name="topo1")(
            x, edge_index, num_nodes=num_nodes))
        h_t = GCNConv(self.hidden_dim, name="topo2")(
            h_t, edge_index, num_nodes=num_nodes)
        h_f = nn.relu(GCNConv(self.hidden_dim, name="feat1")(
            x, feat_edge_index, num_nodes=num_nodes))
        h_f = GCNConv(self.hidden_dim, name="feat2")(
            h_f, feat_edge_index, num_nodes=num_nodes)
        # common-view encoder applied to both graphs
        c1 = nn.relu(GCNConv(self.hidden_dim, name="common")(
            x, edge_index, num_nodes=num_nodes))
        c2 = nn.relu(GCNConv(self.hidden_dim, name="common2")(
            x, feat_edge_index, num_nodes=num_nodes))
        h_c = (c1 + c2) / 2
        # attention fusion over the three channels
        stack = jnp.stack([h_t, h_c, h_f], axis=1)  # (N, 3, D)
        att = nn.tanh(nn.Dense(16)(stack))
        att = jax.nn.softmax(nn.Dense(1, use_bias=False)(att), axis=1)
        fused = (stack * att).sum(1)
        logits = nn.Dense(self.num_class)(fused)
        # consistency: common embeddings of both views should agree
        consistency = ((c1 - c2) ** 2).mean()
        return logits, consistency


class EdgePromptModel(nn.Module):
    """EdgePrompt (reference edgeprompt.py): learnable prompt vectors added
    to messages of a FROZEN pretrained GNN; only prompts + head train."""

    num_class: int
    hidden_dim: int = 64
    num_prompts: int = 4

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None):
        from gammagl_tpu.ops import spmm, segment_softmax
        from gammagl_tpu.ops.segment import segment_count
        if num_nodes is None:
            num_nodes = x.shape[0]
        prompts = self.param("prompts", nn.initializers.normal(0.02),
                             (self.num_prompts, self.hidden_dim))
        h = nn.Dense(self.hidden_dim, name="frozen_enc")(x)
        # per-edge prompt mixture selected by source features
        sel = jax.nn.softmax(nn.Dense(self.num_prompts)(x), axis=-1)
        e_prompt = jnp.take(sel @ prompts, edge_index[0], axis=0,
                            mode="clip")
        msg = jnp.take(h, edge_index[0], axis=0, mode="clip") + e_prompt
        deg = segment_count(edge_index[1], num_nodes, h.dtype)
        from gammagl_tpu.ops.segment import segment_sum
        agg = segment_sum(msg, edge_index[1], num_nodes) / jnp.maximum(
            deg, 1)[:, None]
        return nn.Dense(self.num_class)(nn.relu(agg))


class AMPModel(nn.Module):
    """Adaptive message passing (reference amp.py): per-node halting
    probabilities over propagation steps (ACT-style); the expected-depth
    regularizer stands in for the reference's ELBO term."""

    num_class: int
    hidden_dim: int = 64
    max_steps: int = 5
    tau: float = 1.0

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None):
        from gammagl_tpu.layers.conv.simple_convs import _gcn_weights
        from gammagl_tpu.ops import spmm
        if num_nodes is None:
            num_nodes = x.shape[0]
        w = _gcn_weights(edge_index, num_nodes, edge_weight, x.dtype)
        h = nn.relu(nn.Dense(self.hidden_dim)(x))
        halt_layer = nn.Dense(1)
        acc = jnp.zeros_like(h)
        remain = jnp.ones((h.shape[0], 1), h.dtype)
        expected_depth = jnp.zeros((), h.dtype)
        for step in range(self.max_steps):
            h = spmm(edge_index, w, h, num_nodes=num_nodes)
            p = jax.nn.sigmoid(halt_layer(h) / self.tau)
            use = jnp.where(step == self.max_steps - 1, remain, remain * p)
            acc = acc + use * h
            expected_depth = expected_depth + (step + 1) * use.mean()
            remain = remain * (1 - p)
        logits = nn.Dense(self.num_class)(acc)
        return logits, expected_depth


def dfad_student_loss(student_logits, teacher_logits):
    """DFAD-GNN student objective (reference dfad_gnn.py): L1 between
    student and teacher logits on generated graphs."""
    return jnp.abs(student_logits - jax.lax.stop_gradient(
        teacher_logits)).mean()


def dfad_generator_loss(student_logits, teacher_logits):
    """Generator maximizes the student-teacher disagreement."""
    return -jnp.abs(student_logits - teacher_logits).mean()
