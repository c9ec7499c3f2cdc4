"""GraphGAN, HERec, and GNN-to-MLP distillation (GLNN/LTD-style).

Reference: gammagl/models/{graphgan,herec}.py and the example-only
distillation trainers (examples/glnn, examples/ltd).
"""

from typing import Optional

import numpy as np
from gammagl_tpu import nn
import jax
import jax.numpy as jnp
import optax

__all__ = ["GraphGAN", "herec", "distill_loss", "GLNNStudent"]


class GraphGAN(nn.Module):
    """GraphGAN (Wang 2018; reference graphgan.py): generator and
    discriminator embedding tables trained adversarially over sampled
    (node, neighbor) pairs."""

    num_nodes: int
    embedding_dim: int = 64

    def setup(self):
        init = nn.initializers.normal(0.1)
        self.gen_emb = self.param("gen_emb", init,
                                  (self.num_nodes, self.embedding_dim))
        self.gen_bias = self.param("gen_bias", nn.initializers.zeros,
                                   (self.num_nodes,))
        self.dis_emb = self.param("dis_emb", init,
                                  (self.num_nodes, self.embedding_dim))
        self.dis_bias = self.param("dis_bias", nn.initializers.zeros,
                                   (self.num_nodes,))

    def gen_score(self, u, v):
        return (jnp.sum(self.gen_emb[u] * self.gen_emb[v], -1)
                + self.gen_bias[v])

    def dis_score(self, u, v):
        return (jnp.sum(self.dis_emb[u] * self.dis_emb[v], -1)
                + self.dis_bias[v])

    def discriminator_loss(self, u, v, label):
        """label 1 for true edges, 0 for generator samples."""
        s = self.dis_score(u, v)
        return optax.sigmoid_binary_cross_entropy(s, label).mean()

    def generator_loss(self, u, v):
        """Policy-gradient-style: reward = log(1 + exp(D)) (reference
        graphgan reward), maximize reward-weighted log-prob."""
        reward = jnp.log1p(jnp.exp(self.dis_score(u, v)))
        logp = jax.nn.log_sigmoid(self.gen_score(u, v))
        return -(logp * jax.lax.stop_gradient(reward)).mean()

    def __call__(self, u, v, label=None):
        if label is None:
            return self.generator_loss(u, v)
        return self.discriminator_loss(u, v, label)


def herec(metapath_embeddings, ratings=None, dim=None):
    """HERec fusion (Shi 2018; reference herec.py): fuse per-metapath
    node2vec embeddings by concatenation + mean (the simple fusion
    variant); downstream rating prediction is a linear model the caller
    trains."""
    embs = [np.asarray(e) for e in metapath_embeddings]
    mean = np.mean(np.stack(embs, 0), axis=0)
    return np.concatenate(embs + [mean], axis=1)


def distill_loss(student_logits, teacher_logits, labels, train_mask,
                 lam=0.5, temperature=1.0):
    """GLNN objective (Zhang 2022): CE on labeled nodes + KL to the teacher
    everywhere."""
    t = temperature
    ce = optax.softmax_cross_entropy_with_integer_labels(
        student_logits, labels)
    ce = (ce * train_mask).sum() / jnp.maximum(train_mask.sum(), 1)
    kl = optax.softmax_cross_entropy(
        student_logits / t, jax.nn.softmax(teacher_logits / t)).mean()
    return lam * ce + (1 - lam) * kl * t * t


class GLNNStudent(nn.Module):
    """MLP student distilled from a GNN teacher (reference examples/glnn)."""

    hidden_dim: int = 128
    num_class: int = 7
    num_layers: int = 2
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, x, train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        for _ in range(self.num_layers - 1):
            x = nn.relu(nn.Dense(self.hidden_dim)(x))
            x = drop(x)
        return nn.Dense(self.num_class)(x)
