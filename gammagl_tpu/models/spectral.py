"""Spectral-filter models: Specformer, MGNNI (implicit GNN).

Reference: gammagl/models/{specformer,mgnni}.py,
gammagl/layers/conv/mgnni_m_iter.py.
"""

from typing import Optional

import numpy as np
from gammagl_tpu import nn
import jax
import jax.numpy as jnp

from gammagl_tpu.ops import spmm

__all__ = ["SpecformerModel", "laplacian_eigh", "MGNNIModel"]


def laplacian_eigh(edge_index, num_nodes, k=None):
    """Host-side eigendecomposition of the sym-normalized Laplacian.

    Returns (eigenvalues (K,), eigenvectors (N, K)); k=None -> full.
    """
    import scipy.sparse as sp
    ei = np.asarray(edge_index)
    a = sp.coo_matrix((np.ones(ei.shape[1]), (ei[0], ei[1])),
                      shape=(num_nodes, num_nodes))
    a = ((a + a.T) > 0).astype(np.float64)
    deg = np.asarray(a.sum(1)).reshape(-1)
    dis = np.where(deg > 0, deg ** -0.5, 0.0)
    lap = sp.eye(num_nodes) - sp.diags(dis) @ a @ sp.diags(dis)
    if k is None or k >= num_nodes - 1:
        w, v = np.linalg.eigh(lap.toarray())
    else:
        from scipy.sparse.linalg import eigsh
        w, v = eigsh(lap.tocsc(), k=k, which="SM")
    return w.astype(np.float32), v.astype(np.float32)


class _EigEncoding(nn.Module):
    """Sinusoidal eigenvalue encoding (Specformer eq. 3)."""

    dim: int = 32

    @nn.compact
    def __call__(self, lam):
        d = self.dim // 2
        freqs = jnp.exp(jnp.arange(d) * (-np.log(10000.0) / d))
        ang = lam[:, None] * freqs[None] * 100
        return jnp.concatenate(
            [lam[:, None], jnp.sin(ang), jnp.cos(ang)], axis=-1)


class SpecformerModel(nn.Module):
    """Specformer (Bo 2023; reference specformer.py): a set-to-set
    transformer over Laplacian eigenvalues produces learned spectral
    filters; convolution = U diag(filter_m) U^T X per filter head.

    All compute is dense matmul.
    """

    num_class: int
    hidden_dim: int = 32
    num_heads: int = 4
    num_filters: int = 4
    drop_rate: float = 0.2

    @nn.compact
    def __call__(self, x, eigenvalues, eigenvectors, train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        lam = eigenvalues
        u = eigenvectors  # (N, K)
        h = _EigEncoding(self.hidden_dim)(lam)
        h = nn.Dense(self.hidden_dim)(h)
        # one transformer block over the eigenvalue sequence
        attn = nn.SelfAttention(num_heads=self.num_heads,
                                qkv_features=self.hidden_dim,
                                deterministic=not train)(h[None])[0]
        h = nn.LayerNorm()(h + attn)
        ff = nn.Dense(self.hidden_dim)(nn.gelu(nn.Dense(
            2 * self.hidden_dim)(h)))
        h = nn.LayerNorm()(h + ff)
        # per-eigenvalue filter bank: (K, M) new eigenvalues
        filters = nn.Dense(self.num_filters)(h) + lam[:, None]
        x = drop(x)
        x = nn.relu(nn.Dense(self.hidden_dim)(x))
        spec = u.T @ x  # (K, F)
        outs = [x]
        for m in range(self.num_filters):
            outs.append(u @ (filters[:, m:m + 1] * spec))
        out = jnp.concatenate(outs, axis=-1)
        out = drop(out)
        return nn.Dense(self.num_class)(out)


class MGNNIModel(nn.Module):
    """Multiscale implicit GNN (Liu 2022; reference mgnni.py /
    mgnni_m_iter.py): equilibrium z* = gamma * g(A^m) z W + f(x), solved by
    damped fixed-point iteration (unrolled for autodiff)."""

    num_class: int
    hidden_dim: int = 64
    scales: tuple = (1, 2)
    gamma: float = 0.8
    iters: int = 10

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None,
                 train=False):
        if num_nodes is None:
            num_nodes = x.shape[0]
        from gammagl_tpu.layers.conv.simple_convs import _gcn_weights
        w = _gcn_weights(edge_index, num_nodes, edge_weight, x.dtype)
        fx = nn.Dense(self.hidden_dim)(x)
        outs = []
        for m in self.scales:
            wm = self.param(f"w_{m}", nn.initializers.orthogonal(),
                            (self.hidden_dim, self.hidden_dim))
            # spectral-radius control: scale by 1/||W|| like the reference's
            # projection step
            wm = wm / (jnp.linalg.norm(wm, 2) + 1e-6)
            z = jnp.zeros_like(fx)
            for _ in range(self.iters):
                az = z
                for _ in range(m):
                    az = spmm(edge_index, w, az, num_nodes=num_nodes)
                z = self.gamma * az @ wm + fx
            outs.append(z)
        out = jnp.concatenate(outs, axis=-1)
        return nn.Dense(self.num_class)(out)
