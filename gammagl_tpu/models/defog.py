"""DeFoG: discrete flow matching for graph generation (Qin 2025).

Reference: gammagl/models/defog.py:1-206 (graph-transformer denoiser over
dense (X, E, y) with FiLM conditioning between node/edge/global streams,
XEyTransformerLayer from gammagl/layers/attention/defog_layer.py:267) and
examples/defog/flow_matching.py (linear-interpolation noising of categorical
node/edge types, Euler sampling toward the predicted clean distribution).

All tensors are dense (B?, N, *) -- pure dense matmuls. Here the
per-graph (no batch dim) variant is given; vmap for batches.
"""

import math
from typing import Dict

import numpy as np
from gammagl_tpu import nn
import jax
import jax.numpy as jnp

__all__ = ["DeFoGModel", "XEyTransformerLayer", "timestep_embedding",
           "flow_interpolate", "euler_sample_step"]


def timestep_embedding(t, dim, max_period=10000):
    """Sinusoidal timestep embedding (reference defog.py:_timestep_embedding)."""
    half = dim // 2
    freqs = jnp.exp(-math.log(max_period)
                    * jnp.arange(half, dtype=jnp.float32) / half)
    args = jnp.reshape(t, (-1, 1)).astype(jnp.float32) * freqs[None]
    emb = jnp.concatenate([jnp.cos(args), jnp.sin(args)], axis=-1)
    if dim % 2 == 1:
        emb = jnp.pad(emb, ((0, 0), (0, 1)))
    return emb


class XEyTransformerLayer(nn.Module):
    """Node/edge/global co-attention block (reference defog_layer.py:267):
    self-attention over nodes with edge features FiLM-modulating the
    attention logits, edge stream updated from attention maps, global y
    stream FiLM-conditioning both."""

    dx: int
    de: int
    dy: int
    n_head: int

    @nn.compact
    def __call__(self, X, E, y, node_mask=None):
        # X: (N, dx), E: (N, N, de), y: (dy,)
        H = self.n_head
        D = self.dx // H
        N = X.shape[0]
        q = nn.Dense(H * D)(X).reshape(N, H, D)
        k = nn.Dense(H * D)(X).reshape(N, H, D)
        v = nn.Dense(H * D)(X).reshape(N, H, D)
        scores = jnp.einsum("nhd,mhd->nmh", q, k) / math.sqrt(D)
        # FiLM of attention logits by edge features
        e_mul = nn.Dense(H)(E)
        e_add = nn.Dense(H)(E)
        scores = scores * (e_mul + 1) + e_add
        # new edge stream from the pre-softmax interaction
        newE = nn.Dense(self.de)(scores)
        y_e_mul = nn.Dense(self.de)(y)
        y_e_add = nn.Dense(self.de)(y)
        newE = newE * (y_e_mul + 1) + y_e_add
        E_out = nn.LayerNorm()(E + nn.Dense(self.de)(nn.relu(newE)))

        if node_mask is not None:
            big_neg = -1e9
            m = node_mask[None, :, None]
            scores = jnp.where(m, scores, big_neg)
        attn = jax.nn.softmax(scores, axis=1)
        out = jnp.einsum("nmh,mhd->nhd", attn, v).reshape(N, H * D)
        y_x_mul = nn.Dense(self.dx)(y)
        y_x_add = nn.Dense(self.dx)(y)
        out = out * (y_x_mul + 1) + y_x_add
        X_out = nn.LayerNorm()(X + nn.Dense(self.dx)(nn.relu(out)))

        # global stream from pooled node/edge features
        y_new = (nn.Dense(self.dy)(y)
                 + nn.Dense(self.dy)(X_out.mean(0))
                 + nn.Dense(self.dy)(E_out.mean((0, 1))))
        y_out = nn.LayerNorm()(y + nn.relu(y_new))
        return X_out, E_out, y_out


class DeFoGModel(nn.Module):
    """Graph-transformer denoiser: (noisy X, E, y, t) -> clean logits."""

    n_layers: int
    input_dims: Dict[str, int]
    hidden_mlp_dims: Dict[str, int]
    hidden_dims: Dict[str, int]
    output_dims: Dict[str, int]

    @nn.compact
    def __call__(self, X, E, y, t, node_mask=None):
        """X: (N, dX) one-hot-ish node types; E: (N, N, dE); y: (dy,);
        t: scalar time in [0, 1]."""
        t_emb = timestep_embedding(t, 64)[0]
        y = jnp.concatenate([jnp.atleast_1d(y).reshape(-1), t_emb])

        h_X = nn.Sequential([
            nn.Dense(self.hidden_mlp_dims["X"]), nn.relu,
            nn.Dense(self.hidden_dims["dx"]), nn.relu])(X)
        E_sym = (E + jnp.swapaxes(E, 0, 1)) / 2
        h_E = nn.Sequential([
            nn.Dense(self.hidden_mlp_dims["E"]), nn.relu,
            nn.Dense(self.hidden_dims["de"]), nn.relu])(E_sym)
        h_y = nn.Sequential([
            nn.Dense(self.hidden_mlp_dims["y"]), nn.relu,
            nn.Dense(self.hidden_dims["dy"]), nn.relu])(y)

        for _ in range(self.n_layers):
            h_X, h_E, h_y = XEyTransformerLayer(
                dx=self.hidden_dims["dx"], de=self.hidden_dims["de"],
                dy=self.hidden_dims["dy"],
                n_head=self.hidden_dims["n_head"])(h_X, h_E, h_y,
                                                   node_mask)

        out_X = nn.Dense(self.output_dims["X"])(nn.relu(nn.Dense(
            self.hidden_mlp_dims["X"])(h_X)))
        out_E = nn.Dense(self.output_dims["E"])(nn.relu(nn.Dense(
            self.hidden_mlp_dims["E"])(h_E)))
        out_E = (out_E + jnp.swapaxes(out_E, 0, 1)) / 2
        out_y = nn.Dense(self.output_dims["y"])(h_y)
        return out_X, out_E, out_y


def flow_interpolate(rng, X0, E0, t):
    """Discrete flow noising (reference examples/defog/flow_matching.py):
    with probability (1 - t) resample each categorical entry uniformly;
    at t=1 the clean graph, at t=0 pure noise. X0 (N, dX), E0 (N, N, dE)
    one-hot."""
    kx, ke = jax.random.split(rng)
    N, dX = X0.shape
    dE = E0.shape[-1]
    keep_x = jax.random.bernoulli(kx, t, (N,))
    rand_x = jax.nn.one_hot(
        jax.random.randint(kx, (N,), 0, dX), dX)
    Xt = jnp.where(keep_x[:, None], X0, rand_x)
    keep_e = jax.random.bernoulli(ke, t, (N, N))
    keep_e = jnp.triu(keep_e) + jnp.triu(keep_e, 1).T  # symmetric
    rand_e = jax.nn.one_hot(
        jax.random.randint(ke, (N, N), 0, dE), dE)
    rand_e = (rand_e + jnp.swapaxes(rand_e, 0, 1)) / 2
    Et = jnp.where(keep_e[..., None] > 0, E0, rand_e)
    return Xt, Et


def euler_sample_step(rng, Xt, Et, pred_X_logits, pred_E_logits, t, dt):
    """One Euler step of the CTMC sampler toward the predicted clean
    distribution (reference examples/defog/sampler.py): jump to a sample of
    p(clean) with probability dt / (1 - t)."""
    kx, ke = jax.random.split(rng)
    jump_p = jnp.clip(dt / jnp.maximum(1 - t, dt), 0.0, 1.0)
    N, dX = pred_X_logits.shape
    dE = pred_E_logits.shape[-1]
    new_x = jax.nn.one_hot(
        jax.random.categorical(kx, pred_X_logits), dX)
    jump_x = jax.random.bernoulli(kx, jump_p, (N,))
    Xn = jnp.where(jump_x[:, None], new_x, Xt)
    new_e_idx = jax.random.categorical(ke, pred_E_logits)
    new_e_idx = jnp.triu(new_e_idx) + jnp.triu(new_e_idx, 1).T
    new_e = jax.nn.one_hot(new_e_idx, dE)
    jump_e = jax.random.bernoulli(ke, jump_p, (N, N))
    jump_e = jnp.triu(jump_e) | jnp.triu(jump_e, 1).T
    En = jnp.where(jump_e[..., None], new_e, Et)
    return Xn, En
