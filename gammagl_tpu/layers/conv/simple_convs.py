"""Classic spectral / propagation convs: SGC, GIN, APPNP, GCNII, Cheb, AGNN,
FAGCN, GPR, MixHop, JumpingKnowledge.

Reference semantics per file in gammagl/layers/conv/: sgc_conv.py,
gin_conv.py, appnp_conv.py, gcnii_conv.py, cheb_conv.py, agnn_conv.py,
fagcn_conv.py, gpr_conv.py, mixhop_conv.py, jumping_knowledge.py.
"""

from typing import Any, Callable, Optional, Sequence

from gammagl_tpu import nn
import jax.numpy as jnp

from gammagl_tpu.layers.conv.message_passing import MessagePassing
from gammagl_tpu.ops import sddmm_dot, segment_softmax
from gammagl_tpu.ops.segment import segment_count
from gammagl_tpu.utils.norm import calc_gcn_norm

__all__ = ["SGConv", "GINConv", "APPNPConv", "GCNIIConv", "ChebConv",
           "AGNNConv", "FAGCNConv", "GPRConv", "MixHopConv",
           "JumpingKnowledge"]


def _gcn_weights(edge_index, num_nodes, edge_weight, dtype):
    src, dst = edge_index[0], edge_index[1]
    if edge_weight is None:
        edge_weight = jnp.ones(edge_index.shape[1], dtype=dtype)
    deg = segment_count(dst, num_nodes, dtype)
    dis = jnp.where(deg > 0, deg ** -0.5, 0.0)
    return dis[src] * edge_weight * dis[dst]


class SGConv(MessagePassing):
    """Simplified GCN: A^k X W (reference sgc_conv.py)."""

    out_channels: int
    itera_k: int = 2

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        x = nn.Dense(self.out_channels,
                     kernel_init=nn.initializers.glorot_uniform())(x)
        w = _gcn_weights(edge_index, num_nodes, edge_weight, x.dtype)
        for _ in range(self.itera_k):
            x = self.propagate(x, edge_index, edge_weight=w,
                               num_nodes=num_nodes)
        return x


class GINConv(MessagePassing):
    """GIN: MLP((1 + eps) x_i + sum_j x_j) (reference gin_conv.py)."""

    apply_func: Optional[Callable] = None
    init_eps: float = 0.0
    learn_eps: bool = False

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        if self.learn_eps:
            eps = self.param("eps", lambda k: jnp.asarray(self.init_eps))
        else:
            eps = self.init_eps
        agg = self.propagate(x, edge_index, num_nodes=num_nodes)
        out = (1 + eps) * x + agg
        if self.apply_func is not None:
            out = self.apply_func(out)
        return out


class APPNPConv(MessagePassing):
    """Approximate personalized PageRank propagation (reference appnp_conv.py):
    h^{t+1} = (1-alpha) A_hat h^t + alpha h^0."""

    itera_k: int = 10
    alpha: float = 0.1
    edge_dropout: float = 0.0

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None,
                 train=False):
        if num_nodes is None:
            num_nodes = x.shape[0]
        w = _gcn_weights(edge_index, num_nodes, edge_weight, x.dtype)
        h0 = x
        drop = nn.Dropout(self.edge_dropout, deterministic=not train)
        for _ in range(self.itera_k):
            wk = drop(w) if self.edge_dropout > 0 else w
            x = ((1 - self.alpha)
                 * self.propagate(x, edge_index, edge_weight=wk,
                                  num_nodes=num_nodes)
                 + self.alpha * h0)
        return x


class GCNIIConv(MessagePassing):
    """GCNII (reference gcnii_conv.py): initial residual + identity map.

    h = ((1-alpha) A_hat x + alpha h0); out = (1-beta) h + beta W h.
    """

    out_channels: int
    beta: float = 0.1
    alpha: float = 0.1
    variant: bool = False

    @nn.compact
    def __call__(self, x, x0, edge_index, edge_weight=None, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        if edge_weight is None:
            edge_weight = calc_gcn_norm(edge_index, num_nodes)
        dense = nn.Dense(self.out_channels, use_bias=False,
                         kernel_init=nn.initializers.glorot_uniform())
        agg = self.propagate(x, edge_index, edge_weight=edge_weight,
                             num_nodes=num_nodes)
        if self.variant:
            # variant=True concatenates [A_hat x, x0] before the transform
            support = jnp.concatenate(
                [(1 - self.alpha) * agg, self.alpha * x0], axis=-1)
            h = (1 - self.alpha) * agg + self.alpha * x0
            out = (1 - self.beta) * h + self.beta * nn.Dense(
                self.out_channels, use_bias=False,
                kernel_init=nn.initializers.glorot_uniform())(support)
        else:
            h = (1 - self.alpha) * agg + self.alpha * x0
            out = (1 - self.beta) * h + self.beta * dense(h)
        return out


class ChebConv(MessagePassing):
    """Chebyshev spectral conv (reference cheb_conv.py): sum_k W_k T_k(L~) x."""

    out_channels: int
    K: int = 3
    normalization: str = "sym"

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None,
                 lambda_max=2.0):
        if num_nodes is None:
            num_nodes = x.shape[0]
        src, dst = edge_index[0], edge_index[1]
        if edge_weight is None:
            edge_weight = jnp.ones(edge_index.shape[1], x.dtype)
        # scaled laplacian weights: L~ = 2L/lambda_max - I applied as
        # off-diagonal -w_sym and diagonal handled via the recurrence.
        deg = segment_count(dst, num_nodes, x.dtype)
        dis = jnp.where(deg > 0, deg ** -0.5, 0.0)
        w = -dis[src] * edge_weight * dis[dst] * (2.0 / lambda_max)
        diag = (2.0 / lambda_max - 1.0)  # scaled (I - ... ) diagonal

        tx_0 = x
        out = nn.Dense(self.out_channels, use_bias=False,
                       kernel_init=nn.initializers.glorot_uniform())(tx_0)
        if self.K > 1:
            tx_1 = self.propagate(x, edge_index, edge_weight=w,
                                  num_nodes=num_nodes) + diag * x
            out = out + nn.Dense(self.out_channels, use_bias=False,
                                 kernel_init=nn.initializers.glorot_uniform()
                                 )(tx_1)
            for _ in range(2, self.K):
                tx_2 = 2 * (self.propagate(tx_1, edge_index, edge_weight=w,
                                           num_nodes=num_nodes)
                            + diag * tx_1) - tx_0
                out = out + nn.Dense(
                    self.out_channels, use_bias=False,
                    kernel_init=nn.initializers.glorot_uniform())(tx_2)
                tx_0, tx_1 = tx_1, tx_2
        return out + self.param("bias", nn.initializers.zeros,
                                (self.out_channels,))


class AGNNConv(MessagePassing):
    """Attention-based GNN (reference agnn_conv.py): cosine-similarity
    attention with learnable temperature beta."""

    init_beta: float = 1.0
    require_grad: bool = True

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        if self.require_grad:
            beta = self.param("beta",
                              lambda k: jnp.asarray(self.init_beta))
        else:
            beta = self.init_beta
        norm = x / (jnp.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)
        e = beta * sddmm_dot(edge_index, norm, norm)
        alpha = segment_softmax(e, edge_index[1], num_nodes)
        return self.propagate(x, edge_index, edge_weight=alpha,
                              num_nodes=num_nodes)


class FAGCNConv(MessagePassing):
    """Frequency-adaptive GCN (reference fagcn_conv.py): signed attention
    alpha = tanh(g . [h_i || h_j]) with symmetric degree norm."""

    hidden_dim: int
    drop_rate: float = 0.0

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        if num_nodes is None:
            num_nodes = x.shape[0]
        src, dst = edge_index[0], edge_index[1]
        gate = nn.Dense(1, use_bias=False,
                        kernel_init=nn.initializers.glorot_uniform())
        h = jnp.concatenate([jnp.take(x, src, axis=0, mode="clip"),
                             jnp.take(x, dst, axis=0, mode="clip")], axis=-1)
        alpha = jnp.tanh(gate(h)).squeeze(-1)
        if self.drop_rate > 0:
            alpha = nn.Dropout(self.drop_rate, deterministic=not train)(
                alpha)
        deg = segment_count(dst, num_nodes, x.dtype)
        dis = jnp.where(deg > 0, deg ** -0.5, 0.0)
        w = dis[src] * alpha * dis[dst]
        return self.propagate(x, edge_index, edge_weight=w,
                              num_nodes=num_nodes)


class GPRConv(MessagePassing):
    """GPR-GNN (reference gpr_conv.py): learnable hop weights gamma_k over
    personalized-PageRank initialization."""

    K: int = 10
    alpha: float = 0.1
    weight_init: str = "PPR"

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]

        def init_gamma(key):
            if self.weight_init == "PPR":
                g = self.alpha * (1 - self.alpha) ** jnp.arange(self.K + 1)
                g = g.at[-1].set((1 - self.alpha) ** self.K)
                return g
            return jnp.full((self.K + 1,), 1.0 / (self.K + 1))

        gamma = self.param("gamma", init_gamma)
        w = _gcn_weights(edge_index, num_nodes, edge_weight, x.dtype)
        out = gamma[0] * x
        h = x
        for k in range(1, self.K + 1):
            h = self.propagate(h, edge_index, edge_weight=w,
                               num_nodes=num_nodes)
            out = out + gamma[k] * h
        return out


class MixHopConv(MessagePassing):
    """MixHop (reference mixhop_conv.py): concat_k W_k A^k x for k in powers."""

    out_channels: int
    p: Sequence[int] = (0, 1, 2)

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        w = _gcn_weights(edge_index, num_nodes, edge_weight, x.dtype)
        max_p = max(self.p)
        outs = []
        h = x
        for k in range(max_p + 1):
            if k in self.p:
                outs.append(nn.Dense(
                    self.out_channels, use_bias=False,
                    kernel_init=nn.initializers.glorot_uniform())(h))
            if k < max_p:
                h = self.propagate(h, edge_index, edge_weight=w,
                                   num_nodes=num_nodes)
        return jnp.concatenate(outs, axis=-1)


class JumpingKnowledge(nn.Module):
    """JK aggregation over layer outputs (reference jumping_knowledge.py):
    'cat' | 'max' | 'lstm'-free attention variant ('att' uses a dense score).
    """

    mode: str = "cat"
    channels: Optional[int] = None

    @nn.compact
    def __call__(self, xs):
        if self.mode == "cat":
            return jnp.concatenate(xs, axis=-1)
        if self.mode == "max":
            return jnp.max(jnp.stack(xs, axis=0), axis=0)
        if self.mode == "att":
            h = jnp.stack(xs, axis=1)  # (N, L, F)
            score = nn.Dense(1)(h).squeeze(-1)  # (N, L)
            att = nn.softmax(score, axis=-1)
            return jnp.sum(h * att[..., None], axis=1)
        raise ValueError(f"unknown mode {self.mode!r}")
