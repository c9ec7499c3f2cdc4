"""SEAL link prediction + CoGSL structure learning.

Reference: gammagl/models/{seal (DGCNN usage), cogsl}.py; DRNL labeling per
the SEAL paper (Zhang & Chen 2018).
"""

from typing import Sequence

import numpy as np
from gammagl_tpu import nn
import jax
import jax.numpy as jnp

from gammagl_tpu.layers.conv import GCNConv
from gammagl_tpu.models.wave2_models import DGCNNModel

__all__ = ["drnl_node_labeling", "SEALModel", "CoGSLModel"]


def drnl_node_labeling(edge_index, num_nodes, src, dst, max_dist=10):
    """Double-radius node labeling: label(i) = 1 + min(d_s, d_t) +
    (d//2)*((d//2) + (d%2) - 1) with d = d_s + d_t; the two targets get
    label 1, unreachable nodes 0. Host-side BFS."""
    adj = [[] for _ in range(num_nodes)]
    for s, d in np.asarray(edge_index).T:
        adj[int(s)].append(int(d))
        adj[int(d)].append(int(s))

    def bfs(start, blocked):
        dist = np.full(num_nodes, -1, np.int64)
        dist[start] = 0
        frontier = [start]
        depth = 0
        while frontier and depth < max_dist:
            depth += 1
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if dist[v] < 0 and v != blocked:
                        dist[v] = depth
                        nxt.append(v)
            frontier = nxt
        return dist

    ds = bfs(src, dst)
    dt = bfs(dst, src)
    labels = np.zeros(num_nodes, np.int64)
    reach = (ds >= 0) & (dt >= 0)
    d = ds + dt
    half = d // 2
    lab = 1 + np.minimum(ds, dt) + half * (half + d % 2 - 1)
    labels[reach] = lab[reach]
    labels[src] = 1
    labels[dst] = 1
    return labels


class SEALModel(nn.Module):
    """SEAL: DGCNN over DRNL-labeled enclosing subgraphs; the label
    embedding is concatenated to (optional) node features."""

    hidden_dim: int = 32
    max_label: int = 64
    k: int = 20

    @nn.compact
    def __call__(self, labels, edge_index, x=None, batch=None,
                 num_graphs=None, num_nodes=None):
        z = nn.Embed(self.max_label + 1, self.hidden_dim)(
            jnp.clip(labels, 0, self.max_label))
        if x is not None:
            z = jnp.concatenate([z, x], axis=-1)
        return DGCNNModel(hidden_dim=self.hidden_dim, num_class=1,
                          k=self.k)(z, edge_index, batch, num_graphs,
                                    num_nodes)


class CoGSLModel(nn.Module):
    """Compact graph structure learning (Liu 2022; reference cogsl.py):
    two view-specific GCN classifiers + a confidence-weighted fused view;
    returns per-view logits and a contrastive alignment loss."""

    num_class: int
    hidden_dim: int = 32
    tau: float = 0.5

    @nn.compact
    def __call__(self, x, ei_view1, ei_view2, num_nodes=None):
        from gammagl_tpu.models.ssl import grace_loss

        def encode(name, ei):
            h = nn.relu(GCNConv(self.hidden_dim, name=f"{name}_1")(
                x, ei, num_nodes=num_nodes))
            return GCNConv(self.hidden_dim, name=f"{name}_2")(
                h, ei, num_nodes=num_nodes)

        z1 = encode("v1", ei_view1)
        z2 = encode("v2", ei_view2)
        logits1 = nn.Dense(self.num_class, name="cls1")(z1)
        logits2 = nn.Dense(self.num_class, name="cls2")(z2)
        # confidence = softmax margin per node, used to fuse the views
        def conf(lg):
            p = jax.nn.softmax(lg, -1)
            top2 = jax.lax.top_k(p, 2)[0]
            return top2[:, 0] - top2[:, 1]

        c1, c2 = conf(logits1), conf(logits2)
        w1 = c1 / (c1 + c2 + 1e-12)
        z_fused = w1[:, None] * z1 + (1 - w1)[:, None] * z2
        logits_f = nn.Dense(self.num_class, name="cls_f")(z_fused)
        mi_loss = grace_loss(z1, z2, self.tau)
        return (logits1, logits2, logits_f), mi_loss
