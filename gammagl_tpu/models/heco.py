"""HeCo: co-contrastive learning on heterogeneous graphs (Wang 2021).

Reference: gammagl/models/heco.py + gammagl/layers/attention/
heco_encoder.py:131,159 -- a network-schema view (per-neighbor-type
attention around the target type) and a metapath view (GCN per metapath +
semantic attention), trained to agree via a cross-view contrastive loss with
metapath-derived positives.
"""

from typing import Dict, Sequence, Tuple

from gammagl_tpu import nn
import jax
import jax.numpy as jnp

from gammagl_tpu.layers.conv import GCNConv
from gammagl_tpu.layers.conv.hetero_conv import SemAttAggr
from gammagl_tpu.ops import segment_softmax
from gammagl_tpu.ops.segment import segment_sum

__all__ = ["HeCoModel", "heco_contrast_loss"]


class _SchemaEncoder(nn.Module):
    """Network-schema view: attention over each neighbor type's sampled
    neighbors, then type-level attention (reference heco_encoder.py:131)."""

    hidden_dim: int
    target: str
    metadata: Tuple

    @nn.compact
    def __call__(self, h_dict, edge_index_dict, num_target, train=False):
        per_type = []
        for et in self.metadata[1]:
            src_t, _, dst_t = et
            if dst_t != self.target or et not in edge_index_dict:
                continue
            ei = edge_index_dict[et]
            name = "__".join(et)
            att = self.param(f"att__{name}",
                             nn.initializers.truncated_normal(0.02),
                             (1, 2 * self.hidden_dim))
            h_src = jnp.take(h_dict[src_t], ei[0], axis=0, mode="clip")
            h_dst = jnp.take(h_dict[self.target], ei[1], axis=0,
                             mode="clip")
            e = nn.leaky_relu(jnp.sum(
                jnp.concatenate([h_dst, h_src], -1) * att, -1), 0.2)
            alpha = segment_softmax(e, ei[1], num_target)
            per_type.append(segment_sum(h_src * alpha[:, None], ei[1],
                                        num_target))
        return SemAttAggr(hidden_size=self.hidden_dim)(
            jnp.stack(per_type, 0))


class _MetapathEncoder(nn.Module):
    """Metapath view: GCN over each metapath-induced graph + semantic
    attention (reference heco_encoder.py:159)."""

    hidden_dim: int

    @nn.compact
    def __call__(self, h_target, metapath_edges, num_target):
        outs = []
        for i, ei in enumerate(metapath_edges):
            outs.append(nn.relu(GCNConv(self.hidden_dim,
                                        name=f"gcn_{i}")(
                h_target, ei, num_nodes=num_target)))
        return SemAttAggr(hidden_size=self.hidden_dim)(jnp.stack(outs, 0))


def heco_contrast_loss(z_sc, z_mp, pos_mask, tau=0.8, lam=0.5):
    """Cross-view InfoNCE where metapath-frequent pairs are positives
    (reference heco.py contrast module)."""

    def norm(z):
        return z / (jnp.linalg.norm(z, axis=-1, keepdims=True) + 1e-12)

    z1, z2 = norm(z_sc), norm(z_mp)
    sim12 = jnp.exp(z1 @ z2.T / tau)
    sim21 = sim12.T
    pos = pos_mask.astype(z1.dtype)

    def side(sim):
        p = (sim * pos).sum(1)
        return -jnp.log(p / (sim.sum(1) + 1e-12) + 1e-12)

    return (lam * side(sim12) + (1 - lam) * side(sim21)).mean()


class HeCoModel(nn.Module):
    metadata: Tuple
    target_ntype: str
    hidden_dim: int = 64
    feat_drop: float = 0.3
    tau: float = 0.8
    lam: float = 0.5

    @nn.compact
    def __call__(self, x_dict, edge_index_dict, metapath_edges,
                 pos_mask=None, train=False):
        drop = nn.Dropout(self.feat_drop, deterministic=not train)
        h_dict = {nt: nn.elu(drop(nn.Dense(self.hidden_dim,
                                           name=f"proj__{nt}")(x)))
                  for nt, x in x_dict.items()}
        n_t = h_dict[self.target_ntype].shape[0]
        z_sc = _SchemaEncoder(self.hidden_dim, self.target_ntype,
                              self.metadata)(h_dict, edge_index_dict, n_t,
                                             train=train)
        z_mp = _MetapathEncoder(self.hidden_dim)(
            h_dict[self.target_ntype], metapath_edges, n_t)
        proj = nn.Sequential([nn.Dense(self.hidden_dim), nn.elu,
                              nn.Dense(self.hidden_dim)])
        if pos_mask is None:
            return z_mp  # embeddings for downstream eval
        return heco_contrast_loss(proj(z_sc), proj(z_mp), pos_mask,
                                  self.tau, self.lam)
