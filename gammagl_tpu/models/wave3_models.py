"""Wave-3 models: SGFormer, GNN-LF/HF, HiD-Net, CAGCN, HPN, ieHGCN,
RoheHAN, MERIT, GRADE, TADW.

Reference: gammagl/models/{sgformer,gnnlfhf,hid_net,cagcn,hpn,iehgcn,
rohehan,merit,grade,tadw}.py.
"""

from typing import Optional, Tuple

import numpy as np
from gammagl_tpu import nn
import jax
import jax.numpy as jnp

from gammagl_tpu.layers.conv import GCNConv
from gammagl_tpu.layers.conv.hetero_wave2 import (HPNConv, ieHGCNConv,
                                                  HidConv, RoheHANConv)
from gammagl_tpu.models.ssl import _GCNEncoder, grace_loss
from gammagl_tpu.ops.segment import segment_count

__all__ = ["SGFormerModel", "GNNLFHFModel", "HiDNetModel", "CAGCNModel",
           "HPNModel", "ieHGCNModel", "RoheHANModel", "MERITModel",
           "GRADEModel", "tadw"]


class SGFormerModel(nn.Module):
    """SGFormer (Wu 2023; reference sgformer.py + sgformer_layer.py:6,52):
    one linear global-attention layer (l2-normalized q/k, O(N) via the
    associativity trick) combined with a GCN branch."""

    hidden_dim: int = 64
    num_class: int = 7
    num_heads: int = 1
    gcn_layers: int = 2
    graph_weight: float = 0.8
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None,
                 train=False):
        H, D = self.num_heads, self.hidden_dim
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        # global linear attention branch
        h = nn.Dense(D)(x)
        q = nn.Dense(H * D, use_bias=False)(h).reshape(-1, H, D)
        k = nn.Dense(H * D, use_bias=False)(h).reshape(-1, H, D)
        v = nn.Dense(H * D, use_bias=False)(h).reshape(-1, H, D)
        q = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)
        k = k / (jnp.linalg.norm(k, axis=-1, keepdims=True) + 1e-12)
        # linear attention: softmax-free, associativity gives O(N D^2)
        kv = jnp.einsum("nhd,nhe->hde", k, v)
        k_sum = k.sum(axis=0)  # (H, D)
        num = jnp.einsum("nhd,hde->nhe", q, kv)
        den = jnp.einsum("nhd,hd->nh", q, k_sum)[..., None] + x.shape[0]
        attn_out = (num + v) / den  # +v: self term, as in reference
        attn_out = attn_out.mean(axis=1)
        # GCN branch
        g = x
        for _ in range(self.gcn_layers - 1):
            g = nn.relu(GCNConv(D)(g, edge_index, edge_weight, num_nodes))
            g = drop(g)
        g = GCNConv(D)(g, edge_index, edge_weight, num_nodes)
        out = (self.graph_weight * g
               + (1 - self.graph_weight) * attn_out)
        return nn.Dense(self.num_class)(nn.relu(out))


class GNNLFHFModel(nn.Module):
    """GNN-LF/HF (Zhu 2021; reference gnnlfhf.py): unified low/high-pass
    closed-form propagation h^{t+1} = (terms in mu, alpha, beta)."""

    hidden_dim: int = 64
    num_class: int = 7
    variant: str = "lf"  # 'lf' (low-pass) or 'hf' (high-pass)
    alpha: float = 0.1
    mu: float = 0.1
    beta: float = 0.5
    K: int = 10
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None,
                 train=False):
        from gammagl_tpu.layers.conv.simple_convs import _gcn_weights
        if num_nodes is None:
            num_nodes = x.shape[0]
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        h = drop(x)
        h = nn.relu(nn.Dense(self.hidden_dim)(h))
        h = drop(h)
        h = nn.Dense(self.num_class)(h)
        w = _gcn_weights(edge_index, num_nodes, edge_weight, h.dtype)

        def prop(z):
            from gammagl_tpu.ops import spmm
            return spmm(edge_index, w, z, num_nodes=num_nodes)

        h0 = h
        if self.variant == "lf":
            # GNN-LF: z <- (1-alpha) [(1-beta) A z + beta A h0... ] closed
            # iteration from the paper (eq. 17)
            for _ in range(self.K):
                h = ((1 - self.alpha) * ((1 - self.mu) * prop(h)
                                         + self.mu * prop(prop(h)))
                     + self.alpha * h0)
        else:
            # GNN-HF: emphasize high-frequency residual (eq. 20)
            for _ in range(self.K):
                ah = prop(h)
                h = ((1 - self.alpha) * (ah + self.beta * (h - ah))
                     + self.alpha * h0)
        return h


class HiDNetModel(nn.Module):
    """HiD-Net (reference hid_net.py): MLP head + stacked HidConv diffusion."""

    hidden_dim: int = 64
    num_class: int = 7
    num_layers: int = 10
    alpha: float = 0.1
    beta: float = 0.9
    gamma: float = 0.3
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None,
                 train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        h = drop(x)
        h = nn.relu(nn.Dense(self.hidden_dim)(h))
        h = drop(h)
        h = nn.Dense(self.num_class)(h)
        origin = h
        for _ in range(self.num_layers):
            h = HidConv(alpha=self.alpha, beta=self.beta,
                        gamma=self.gamma)(h, origin, edge_index,
                                          edge_weight, num_nodes)
        return h


class CAGCNModel(nn.Module):
    """CAGCN confidence calibration (reference cagcn.py): a base model's
    logits are re-propagated by a calibration GCN producing per-node
    temperature."""

    num_class: int
    hidden_dim: int = 16
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, logits, edge_index, num_nodes=None, train=False):
        t = GCNConv(self.hidden_dim)(logits, edge_index,
                                     num_nodes=num_nodes)
        t = nn.relu(t)
        t = GCNConv(1)(t, edge_index, num_nodes=num_nodes)
        temperature = nn.softplus(t) + 1e-3
        return logits / temperature


class HPNModel(nn.Module):
    metadata: Tuple
    hidden_channels: int
    num_class: int
    target_ntype: str
    iter_K: int = 3
    alpha: float = 0.1

    @nn.compact
    def __call__(self, x_dict, edge_index_dict, num_nodes_dict=None,
                 train=False):
        out = HPNConv(out_channels=self.hidden_channels,
                      metadata=self.metadata, iter_K=self.iter_K,
                      alpha=self.alpha)(x_dict, edge_index_dict,
                                        num_nodes_dict, train=train)
        return nn.Dense(self.num_class)(out[self.target_ntype])


class ieHGCNModel(nn.Module):
    metadata: Tuple
    hidden_channels: int
    num_class: int
    target_ntype: str
    num_layers: int = 2

    @nn.compact
    def __call__(self, x_dict, edge_index_dict, num_nodes_dict=None):
        h = {nt: nn.relu(nn.Dense(self.hidden_channels,
                                  name=f"proj__{nt}")(x))
             for nt, x in x_dict.items()}
        for i in range(self.num_layers):
            h = ieHGCNConv(out_channels=self.hidden_channels,
                           metadata=self.metadata, name=f"conv_{i}")(
                h, edge_index_dict, num_nodes_dict)
        return nn.Dense(self.num_class)(h[self.target_ntype])


class RoheHANModel(nn.Module):
    metadata: Tuple
    hidden_channels: int
    num_class: int
    target_ntype: str
    heads: int = 8

    @nn.compact
    def __call__(self, x_dict, edge_index_dict, num_nodes_dict=None,
                 trust_dict=None, train=False):
        out = RoheHANConv(out_channels=self.hidden_channels,
                          metadata=self.metadata, heads=self.heads)(
            x_dict, edge_index_dict, num_nodes_dict, trust_dict,
            train=train)
        return nn.Dense(self.num_class)(out[self.target_ntype])


class MERITModel(nn.Module):
    """MERIT (Jin 2021; reference merit.py): siamese GCN with projector/
    predictor; the EMA target network is handled by the trainer (two
    parameter trees), here we expose online/target forward + BYOL-style
    loss."""

    hidden_dim: int = 128
    num_layers: int = 2

    @nn.compact
    def __call__(self, x1, ei1, w1, x2, ei2, w2, num_nodes=None):
        enc = _GCNEncoder(self.hidden_dim, self.num_layers, act="relu")
        proj = nn.Sequential([nn.Dense(self.hidden_dim), nn.relu,
                              nn.Dense(self.hidden_dim)])
        pred = nn.Sequential([nn.Dense(self.hidden_dim), nn.relu,
                              nn.Dense(self.hidden_dim)])
        z1 = pred(proj(enc(x1, ei1, w1, num_nodes)))
        z2 = pred(proj(enc(x2, ei2, w2, num_nodes)))
        return z1, z2

    @staticmethod
    def byol_loss(p, z_target):
        p = p / (jnp.linalg.norm(p, axis=-1, keepdims=True) + 1e-12)
        z = z_target / (jnp.linalg.norm(z_target, axis=-1,
                                        keepdims=True) + 1e-12)
        return (2 - 2 * (p * z).sum(-1)).mean()


class GRADEModel(nn.Module):
    """GRADE (Wang 2022; reference grade.py): degree-aware GRACE variant --
    NT-Xent with per-node temperature scaled by degree group."""

    hidden_dim: int = 128
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
        proj = nn.Sequential([nn.Dense(self.hidden_dim), nn.elu,
                              nn.Dense(self.hidden_dim)])
        return grace_loss(proj(z1), proj(z2), self.tau)


def tadw(adj, text_features, dim=80, lam=0.2, iters=20, lr=0.01, seed=0):
    """Text-Associated DeepWalk (Yang 2015; reference tadw.py): factorize
    M ~= W^T H T with text matrix T. Host-side numpy ALS-by-gradient.

    Returns (num_nodes, 2*dim) embeddings [W^T || (H T)^T].
    """
    rng = np.random.default_rng(seed)
    a = np.asarray(adj, np.float32)
    deg = a.sum(1, keepdims=True)
    m = a / np.maximum(deg, 1)
    m = (m + m @ m) / 2
    t = np.asarray(text_features, np.float32).T  # (ft, N)
    ft, n = t.shape
    w = rng.normal(size=(dim, n)).astype(np.float32) * 0.1
    h = rng.normal(size=(dim, ft)).astype(np.float32) * 0.1
    for _ in range(iters):
        ht = h @ t  # (dim, N)
        err = w.T @ ht - m  # (N, N)
        gw = ht @ err.T + lam * w
        w = w - lr * gw
        ht_err = w @ err  # (dim, N)
        gh = ht_err @ t.T + lam * h
        h = h - lr * gh
    return np.concatenate([w.T, (h @ t).T], axis=1)
