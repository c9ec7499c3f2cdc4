"""Wave-5 models: SIGN, UniFews-pruned GCN, HardGAT, AdaGAD, Sp2GCL.

Reference: gammagl/models/{sign,gnn_unifews,hardgat,adagad,sp2gcl}.py and
gammagl/layers/conv/{gcn_unifews.py:16-22, hardgat_conv.py}.
"""

from typing import Sequence, Tuple

import numpy as np
from gammagl_tpu import nn
import jax
import jax.numpy as jnp

from gammagl_tpu.layers.conv import GCNConv, MessagePassing
from gammagl_tpu.models.autoencoder import GAEModel
from gammagl_tpu.ops import bspmm, segment_softmax
from gammagl_tpu.utils.pruning import prune_edges_by_weight

__all__ = ["SIGNModel", "GCNUniFews", "HardGATConv", "HardGATModel",
           "AdaGADModel", "Sp2GCLModel"]


class SIGNModel(nn.Module):
    """SIGN (Rossi 2020; reference sign.py + transforms/sign.py:7): the K
    propagated feature sets are precomputed once (transforms.SIGN); training
    is a pure MLP over [x, x1..xK] -- the aggregation leaves the train loop
    entirely, leaving only GEMMs in the inner loop."""

    num_class: int
    hidden_dim: int = 64
    K: int = 3
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, xs: Sequence, train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        hs = []
        for x in xs:
            hs.append(nn.relu(nn.Dense(self.hidden_dim)(drop(x))))
        h = jnp.concatenate(hs, axis=-1)
        h = drop(h)
        return nn.Dense(self.num_class)(h)


class GCNUniFews(nn.Module):
    """UniFews-pruned GCN (reference gcn_unifews.py:16-22): edge weights
    below a threshold become exact no-ops and weight entries are masked --
    unified edge+weight sparsification."""

    num_class: int
    hidden_dim: int = 64
    edge_thr: float = 0.0
    weight_mask: dict = None  # pytree of 0/1 masks matching params

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None,
                 train=False):
        from gammagl_tpu.utils.norm import calc_gcn_norm
        if num_nodes is None:
            num_nodes = x.shape[0]
        if edge_weight is None:
            edge_weight = calc_gcn_norm(edge_index, num_nodes)
        if self.edge_thr > 0:
            edge_weight = prune_edges_by_weight(edge_weight, self.edge_thr)
        h = GCNConv(self.hidden_dim)(x, edge_index, edge_weight, num_nodes)
        h = nn.relu(h)
        return GCNConv(self.num_class)(h, edge_index, edge_weight,
                                       num_nodes)

    @staticmethod
    def apply_weight_masks(params, masks):
        """Mask parameters after each update (train-loop hook)."""
        return jax.tree_util.tree_map(lambda p, m: p * m, params, masks)


class HardGATConv(MessagePassing):
    """Hard graph attention (Gao 2019; reference hardgat_conv.py): a
    per-edge gate keeps only messages whose projected source score ranks in
    the top-k of the destination's neighborhood. The rank test is computed
    per edge against a per-node k-th-score threshold obtained via iterative
    max-peeling (static shapes, no per-node sorts)."""

    out_channels: int
    heads: int = 1
    k: int = 8
    negative_slope: float = 0.2

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None):
        from gammagl_tpu.ops.segment import segment_max
        if num_nodes is None:
            num_nodes = x.shape[0]
        H, F = self.heads, self.out_channels
        src, dst = edge_index[0], edge_index[1]
        proj = nn.Dense(1, use_bias=False)(x).reshape(-1)  # scalar score
        s_e = jnp.take(proj, src, mode="clip")
        # k-th largest score per destination via k rounds of masked max
        cur = s_e
        thr = jnp.full((num_nodes,), jnp.inf, x.dtype)
        for _ in range(self.k):
            m = segment_max(cur, dst, num_nodes)
            thr = jnp.where(jnp.isfinite(m), m, thr)
            cur = jnp.where(cur >= m[jnp.minimum(dst, num_nodes - 1)],
                            -jnp.inf, cur)
        keep = s_e >= thr[jnp.minimum(dst, num_nodes - 1)]
        h = nn.Dense(H * F, use_bias=False)(x).reshape(-1, H, F)
        att = self.param("att", nn.initializers.truncated_normal(0.02),
                         (1, H, 2 * F))
        feat = jnp.concatenate(
            [jnp.take(h, src, axis=0, mode="clip"),
             jnp.take(h, dst, axis=0, mode="clip")], axis=-1)
        e = nn.leaky_relu(jnp.sum(feat * att, -1), self.negative_slope)
        e = jnp.where(keep[:, None], e, -1e9)
        alpha = segment_softmax(e, dst, num_nodes)
        return bspmm(edge_index, alpha, h,
                     num_nodes=num_nodes).reshape(-1, H * F)


class HardGATModel(nn.Module):
    hidden_dim: int = 8
    num_class: int = 7
    heads: int = 8
    k: int = 8

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        x = nn.elu(HardGATConv(out_channels=self.hidden_dim,
                               heads=self.heads, k=self.k)(
            x, edge_index, num_nodes))
        return HardGATConv(out_channels=self.num_class, heads=1,
                           k=self.k)(x, edge_index, num_nodes)


class AdaGADModel(nn.Module):
    """AdaGAD anomaly detection (reference adagad.py PreModel/ReModel):
    masked-reconstruction pretraining (attribute + structure decoders over
    a GCN encoder) and anomaly scoring by reconstruction error."""

    hidden_dim: int = 64
    latent_dim: int = 32

    @nn.compact
    def __call__(self, x, edge_index, neg_edge_index=None, num_nodes=None):
        from gammagl_tpu.models.autoencoder import (inner_product_decoder,
                                                    recon_loss)
        h = nn.relu(GCNConv(self.hidden_dim)(x, edge_index,
                                             num_nodes=num_nodes))
        z = GCNConv(self.latent_dim)(h, edge_index, num_nodes=num_nodes)
        x_rec = nn.Dense(x.shape[-1])(nn.relu(nn.Dense(
            self.hidden_dim)(z)))
        attr_err = jnp.sum((x_rec - x) ** 2, axis=-1)
        if neg_edge_index is None:
            return attr_err  # anomaly score per node
        struct_loss = recon_loss(z, edge_index, neg_edge_index)
        return attr_err.mean() + struct_loss


class Sp2GCLModel(nn.Module):
    """Sp2GCL (Bo 2023; reference sp2gcl.py): contrast spatial (GCN over
    features) vs spectral (eigenvector-positional) views."""

    hidden_dim: int = 64
    tau: float = 0.5

    @nn.compact
    def __call__(self, x, edge_index, eigvecs, num_nodes=None):
        from gammagl_tpu.models.ssl import grace_loss
        spatial = nn.relu(GCNConv(self.hidden_dim)(
            x, edge_index, num_nodes=num_nodes))
        spatial = GCNConv(self.hidden_dim)(spatial, edge_index,
                                           num_nodes=num_nodes)
        spectral = nn.Dense(self.hidden_dim)(eigvecs)
        spectral = nn.relu(spectral)
        spectral = nn.Dense(self.hidden_dim)(spectral)
        proj = nn.Sequential([nn.Dense(self.hidden_dim), nn.elu,
                              nn.Dense(self.hidden_dim)])
        return grace_loss(proj(spatial), proj(spectral), self.tau)
