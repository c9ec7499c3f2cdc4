"""Wave-8 models: GEN (EM adjacency estimation) and FatraGNN (fairness
under distribution shift).

Reference: gammagl/models/gen.py (GEstimationN:8-156) and
gammagl/models/fatragnn.py (FatraGNNModel:45-103, Graph_Editer:105-189).
"""

from collections import Counter

import numpy as np

from gammagl_tpu import nn
import jax.numpy as jnp

from gammagl_tpu.layers.conv import GCNConv
from gammagl_tpu.utils import homophily

__all__ = ["GEstimationN", "FatraGNNModel", "GraphEditer",
           "modify_structure"]


class GEstimationN:
    """EM-based adjacency estimation (reference gen.py:8-156): treats the
    observed graph plus k-NN graphs as noisy measurements `E` of a latent
    SBM-like network and estimates the edge-presence posterior Q.

    Host-side numpy by design — the EM touches dense (N, N) observation
    matrices and runs once per training round, outside the jit step (the
    reference is likewise backend-free numpy)."""

    def __init__(self, num_nodes, num_classes, edge_index, y, train_idx):
        self.num_node = int(num_nodes)
        self.num_class = int(num_classes)
        self.idx_train = np.asarray(train_idx)
        self.label = np.asarray(y)
        ei = np.asarray(edge_index)
        self.adj = np.zeros((self.num_node, self.num_node))
        self.adj[ei[0], ei[1]] = 1.0
        self.output = None
        self.iterations = 0
        self.homophily = float(homophily(jnp.asarray(ei), jnp.asarray(y),
                                         method="node"))

    def reset_obs(self):
        self.N = 0
        self.E = np.zeros((self.num_node, self.num_node), np.int64)

    def update_obs(self, output):
        """Add one observed adjacency (dense 0/1 numpy)."""
        self.E += np.asarray(output, np.int64)
        self.N += 1

    def revise_pred(self):
        self.output[self.idx_train] = self.label[self.idx_train]

    def e_step(self, Q):
        an = np.triu(Q * self.E, 1).sum()
        bn = np.triu((1 - Q) * self.E, 1).sum()
        ad = np.triu(Q * self.N + np.zeros_like(Q), 1).sum()
        bd = np.triu((1 - Q) * self.N, 1).sum()
        alpha = an / ad
        beta = bn / bd

        O = np.zeros((self.num_class, self.num_class))
        counter = Counter(self.output.tolist())
        n = [counter[i] for i in range(self.num_class)]
        a = np.repeat(self.output, self.num_node).reshape(self.num_node, -1)
        for j in range(self.num_class):
            c = a == j
            for i in range(j + 1):
                b = a == i
                O[i, j] = np.triu((b & c.T) * Q, 1).sum()
                if i == j:
                    O[j, j] *= 2.0 / max(n[j] * (n[j] - 1), 1)
                else:
                    O[i, j] *= 1.0 / max(n[i] * n[j], 1)
        return alpha, beta, O

    def m_step(self, alpha, beta, O):
        O = O + O.T - np.diag(O.diagonal())
        row = np.repeat(self.output, self.num_node)
        col = np.tile(self.output, self.num_node)
        tmp = O[row, col].reshape(self.num_node, -1)
        p1 = tmp * np.power(alpha, self.E) * np.power(
            1 - alpha, self.N - self.E)
        p2 = (1 - tmp) * np.power(beta, self.E) * np.power(
            1 - beta, self.N - self.E)
        return p1 / np.maximum(p1 + p2, 1e-12)

    def em(self, output, tolerance=1e-6, seed=0, max_iters=100):
        """Full EM loop (reference gen.py:117-156). Returns
        (alpha, beta, O, Q, iterations)."""
        rng = np.random.default_rng(seed)
        self.output = np.array(output)  # own a writable copy
        self.revise_pred()
        beta, alpha = np.sort(rng.random(2))
        O = np.triu(rng.random((self.num_class, self.num_class)))
        Q = self.m_step(alpha, beta, O)
        alpha_p = beta_p = 0.0
        while (abs(alpha_p - alpha) > tolerance
               or abs(beta_p - beta) > tolerance):
            alpha_p, beta_p = alpha, beta
            alpha, beta, O = self.e_step(Q)
            Q = self.m_step(alpha, beta, O)
            self.iterations += 1
            if self.iterations >= max_iters:
                break
        if self.homophily > 0.5:
            Q = Q + self.adj
        return alpha, beta, O, Q, self.iterations

    # reference-compatible aliases (gen.py method names)
    E_step = e_step
    M_step = m_step
    EM = em


class GraphEditer(nn.Module):
    """Feature perturbation generator (reference fatragnn.py:105-112,
    forward:185-189): x -> x + 0.1 * Linear(x)."""

    num_features: int

    @nn.compact
    def __call__(self, x):
        return x + 0.1 * nn.Dense(self.num_features,
                                  name="transFeature")(x)


def modify_structure(edge_index, a2_edge, sens, drop=0.8, seed=13,
                     align=True):
    """Fairness-aware structure edit (reference fatragnn.py:113-183):
    drop a fraction of sens-mismatched edges and add the same number of
    candidate edges from the 2-hop graph (same-sens when `align`,
    cross-sens otherwise). Host-side numpy — data-dependent shapes."""
    rng = np.random.default_rng(seed)
    ei = np.asarray(edge_index)
    a2 = np.asarray(a2_edge)
    sens = np.asarray(sens)

    mismatch = sens[ei[0]] != sens[ei[1]]
    yipei = np.nonzero(mismatch)[0]
    n_drop = int(len(yipei) * drop)
    drop_ids = rng.choice(yipei, n_drop, replace=False) \
        if n_drop else np.zeros(0, np.int64)
    keep = np.ones(ei.shape[1], bool)
    keep[drop_ids] = False
    kept = ei[:, keep]

    same = (sens[a2[0]] == sens[a2[1]]) if align \
        else (sens[a2[0]] != sens[a2[1]])
    cand = np.nonzero(same & (a2[0] != a2[1]))[0]
    n_add = min(n_drop, len(cand))
    add_ids = rng.choice(cand, n_add, replace=False) \
        if n_add else np.zeros(0, np.int64)
    added = a2[:, add_ids]
    return np.concatenate([added, kept], axis=1)


class FatraGNNModel(nn.Module):
    """FatraGNN (reference fatragnn.py:45-103): GCN encoder + MLP
    classifier + MLP discriminator + feature editer, multiplexed by
    `flag` exactly like the reference forward."""

    num_features: int
    hidden: int = 16

    def setup(self):
        self.encoder = GCNConv(self.hidden, name="encoder")
        self.classifier = nn.Dense(1, name="classifier")
        self.discriminator = nn.Dense(1, name="discriminator")
        self.graph_edit = GraphEditer(self.num_features, name="graphEdit")

    def _enc(self, x, edge_index):
        w = jnp.ones((edge_index.shape[1],), x.dtype)
        return self.encoder(x, edge_index, w, x.shape[0])

    def init_all(self, x, edge_index):
        """Materialize every submodule (use as the `init` method — the
        flag-multiplexed forward only touches one branch at a time)."""
        h = self._enc(x, edge_index)
        return (self.classifier(h), self.discriminator(h),
                self.graph_edit(x))

    def __call__(self, x, edge_index, flag=0, edge_index2=None):
        if flag == 0:
            return self.classifier(self._enc(x, edge_index))
        if flag == 1 or flag == 3:
            return nn.sigmoid(self.discriminator(self._enc(x, edge_index)))
        if flag == 2:
            return nn.sigmoid(self.classifier(self._enc(x, edge_index)))
        if flag == 4:
            x2 = self.graph_edit(x)
            h2 = self._enc(x2, edge_index2)
            h2 = h2 / (jnp.linalg.norm(h2, axis=1, keepdims=True) + 1e-12)
            return self.classifier(h2)
        if flag == 5:
            x2 = self.graph_edit(x)
            h2 = self._enc(x2, edge_index2)
            h1 = self._enc(x, edge_index)
            h2 = h2 / (jnp.linalg.norm(h2, axis=1, keepdims=True) + 1e-12)
            h1 = h1 / (jnp.linalg.norm(h1, axis=1, keepdims=True) + 1e-12)
            return {"h1": h1, "h2": h2}
        raise ValueError(f"unknown flag {flag}")
