"""Graph autoencoders: GAE / VGAE (Kipf 2016).

Reference: gammagl/models/vgae.py (GCN encoder, inner-product decoder,
reconstruction + KL losses).
"""

from gammagl_tpu import nn
import jax
import jax.numpy as jnp

from gammagl_tpu.layers.conv import GCNConv

__all__ = ["GAEModel", "VGAEModel", "inner_product_decoder", "recon_loss"]


def inner_product_decoder(z, edge_index, sigmoid=True):
    src, dst = edge_index[0], edge_index[1]
    val = jnp.sum(z[src] * z[dst], axis=-1)
    return jax.nn.sigmoid(val) if sigmoid else val


def recon_loss(z, pos_edge_index, neg_edge_index):
    pos = inner_product_decoder(z, pos_edge_index, sigmoid=False)
    neg = inner_product_decoder(z, neg_edge_index, sigmoid=False)
    return (-jnp.mean(jax.nn.log_sigmoid(pos))
            - jnp.mean(jax.nn.log_sigmoid(-neg)))


class GAEModel(nn.Module):
    hidden_dim: int = 32
    latent_dim: int = 16

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None):
        h = nn.relu(GCNConv(self.hidden_dim)(x, edge_index, edge_weight,
                                             num_nodes))
        return GCNConv(self.latent_dim)(h, edge_index, edge_weight,
                                        num_nodes)


class VGAEModel(nn.Module):
    hidden_dim: int = 32
    latent_dim: int = 16

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None,
                 rng=None):
        h = nn.relu(GCNConv(self.hidden_dim)(x, edge_index, edge_weight,
                                             num_nodes))
        mu = GCNConv(self.latent_dim)(h, edge_index, edge_weight, num_nodes)
        logstd = GCNConv(self.latent_dim)(h, edge_index, edge_weight,
                                          num_nodes)
        logstd = jnp.clip(logstd, -10, 10)
        if rng is None:
            return mu, logstd, mu
        z = mu + jnp.exp(logstd) * jax.random.normal(rng, mu.shape)
        return mu, logstd, z

    @staticmethod
    def kl_loss(mu, logstd):
        return -0.5 * jnp.mean(
            jnp.sum(1 + 2 * logstd - mu ** 2 - jnp.exp(2 * logstd), axis=1))
