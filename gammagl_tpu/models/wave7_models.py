"""Wave-7 models: DHN, HEAT, CoED, NodeID (residual VQ), GNRF (graph
neural ODE), GRACE-POT, GRACE-Spco.

Reference: gammagl/models/{dhn,heat,coed,nodeid,gnrf,grace_pot,
grace_spco}.py. The reference's GNRF integrates with torchdiffeq
(gnrf.py:31-88); here the ODE solve is a fixed-step RK4 `lax.scan`, which
is jit-compatible and differentiates through the solver. NodeID's EMA
codebook (nodeid.py:39-67, host numpy in the reference) lives in a flax
variable collection updated on-device.
"""

from gammagl_tpu import nn
import jax
import jax.numpy as jnp

from gammagl_tpu.layers.conv import GATConv, GCNConv, JumpingKnowledge
from gammagl_tpu.layers.conv.wave7_convs import CoEDConv, DHNConv, HEATConv
from gammagl_tpu.models.ssl import grace_loss
from gammagl_tpu.ops import spmm
from gammagl_tpu.ops.segment import segment_mean, segment_sum

__all__ = ["DHNModel", "HEATModel", "CoEDModel", "VectorQuantize",
           "ResidualVectorQuant", "NodeIDModel", "odeint_rk4", "GNRFModel",
           "GracePOTModel", "grace_pot_bounds", "GraceSpcoModel"]


class DHNModel(nn.Module):
    """Distance-encoding heterogeneous network for link prediction
    (reference dhn.py:5-28): two DHNConv towers over the endpoint
    neighborhood blocks, concatenated into an MLP scorer."""

    num_fea: int
    num_neighbor: int
    hidden: int = 64

    @nn.compact
    def __call__(self, n1, n2):
        emb1 = DHNConv(self.num_fea, self.num_neighbor, self.hidden,
                       name="dhn1")(n1)
        emb2 = DHNConv(self.num_fea, self.num_neighbor, self.hidden,
                       name="dhn2")(n2)
        h = jnp.concatenate([emb1, emb2], axis=1)
        h = nn.elu(nn.Dense(self.hidden, name="lin1",
                            kernel_init=nn.initializers.xavier_uniform())(h))
        return nn.elu(nn.Dense(1, name="lin2",
                               kernel_init=nn.initializers.xavier_uniform())(
            h))


class HEATModel(nn.Module):
    """HEAT trajectory-prediction backbone (reference heat.py:5-98):
    history encoder -> two HEAT layers -> future-offset decoder."""

    in_channels_node: int = 64
    out_channels: int = 128
    out_length: int = 12
    node_emb_size: int = 64
    edge_attr_emb_size: int = 64
    edge_type_emb_size: int = 64
    heads: int = 3
    concat: bool = True
    dropout_rate: float = 0.1
    leaky_rate: float = 0.2

    @nn.compact
    def __call__(self, x, edge_index, edge_attr, edge_type, train=False):
        node_f = x.reshape(x.shape[0], -1)
        node_f = nn.Dense(self.in_channels_node, name="lin1",
                          kernel_init=nn.initializers.xavier_uniform())(
            node_f)
        kw = dict(node_emb_size=self.node_emb_size,
                  edge_attr_emb_size=self.edge_attr_emb_size,
                  edge_type_emb_size=self.edge_type_emb_size,
                  out_channels=self.out_channels, heads=self.heads,
                  concat=self.concat)
        h = HEATConv(name="heat_conv1", **kw)(node_f, edge_index, edge_attr,
                                              edge_type)
        h = nn.Dropout(self.dropout_rate, deterministic=not train)(h)
        h = HEATConv(name="heat_conv2", **kw)(h, edge_index, edge_attr,
                                              edge_type)
        h = nn.Dropout(self.dropout_rate, deterministic=not train)(h)
        h = nn.leaky_relu(nn.Dense(self.out_channels, name="fc")(h),
                          self.leaky_rate)
        return nn.Dense(self.out_length * 2, name="lin2")(h)


class CoEDModel(nn.Module):
    """CoED-GNN node classification (reference coed.py:14-132): stacked
    directional convs combined as ``alpha*fwd + (1-alpha)*rev (+ self)``
    with optional jumping knowledge."""

    num_class: int
    hidden_dim: int = 64
    num_layers: int = 2
    alpha: float = 0.0
    drop_rate: float = 0.5
    normalize: bool = False
    self_feature_transform: bool = False
    jumping_knowledge: str = ""

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None,
                 train=False):
        xs = []
        for i in range(self.num_layers):
            out = CoEDConv(self.hidden_dim,
                           self_feature_transform=self.self_feature_transform,
                           name=f"conv{i + 1}")(x, edge_index, edge_weight,
                                                num_nodes)
            if len(out) == 3:
                x = (self.alpha * out[0] + (1 - self.alpha) * out[1]
                     + out[2])
            else:
                x = self.alpha * out[0] + (1 - self.alpha) * out[1]
            if i != self.num_layers - 1 or self.jumping_knowledge:
                x = nn.relu(x)
                x = nn.Dropout(self.drop_rate,
                               deterministic=not train)(x)
                if self.normalize:
                    x = x / (jnp.linalg.norm(x, axis=1, keepdims=True)
                             + 1e-12)
                xs.append(x)
        if self.jumping_knowledge:
            x = JumpingKnowledge(self.jumping_knowledge)(xs)
        return nn.Dense(self.num_class, name="readout",
                        kernel_init=nn.initializers.xavier_uniform())(x)


class VectorQuantize(nn.Module):
    """EMA vector quantizer (reference nodeid.py:16-101). Codebook and
    EMA statistics live in the mutable ``vq_stats`` collection; pass
    ``mutable=["vq_stats"]`` to `apply` during training. Assignment uses
    cosine similarity; the forward output is straight-through. Dead codes
    (EMA count below threshold) are refreshed from input rows
    (deterministic round-robin instead of the reference's
    np.random.choice, nodeid.py:58-65)."""

    dim: int
    codebook_size: int
    commitment_weight: float = 0.25
    decay: float = 0.8
    eps: float = 1e-5
    threshold_ema_dead_code: float = 2.0

    @nn.compact
    def __call__(self, x, train=False):
        embed = self.variable(
            "vq_stats", "embed",
            lambda: nn.initializers.xavier_uniform()(
                jax.random.PRNGKey(0), (self.codebook_size, self.dim)))
        embed_avg = self.variable("vq_stats", "embed_avg",
                                  lambda: jnp.array(embed.value))
        cluster_size = self.variable(
            "vq_stats", "cluster_size",
            lambda: jnp.zeros((self.codebook_size,), jnp.float32))

        flat = x.reshape(-1, self.dim)
        xn = flat / (jnp.linalg.norm(flat, axis=1, keepdims=True) + 1e-12)
        en = embed.value / (jnp.linalg.norm(embed.value, axis=1,
                                            keepdims=True) + 1e-12)
        sim = xn @ en.T
        ind = jnp.argmax(sim, axis=-1)
        onehot = jax.nn.one_hot(ind, self.codebook_size, dtype=flat.dtype)
        quantize = onehot @ embed.value

        if train and not self.is_initializing():
            counts = onehot.sum(axis=0)
            embed_sum = onehot.T @ flat
            new_cs = cluster_size.value * self.decay + (
                1 - self.decay) * counts
            new_avg = embed_avg.value * self.decay + (
                1 - self.decay) * embed_sum
            total = new_cs.sum()
            smoothed = jnp.where(
                total > 0,
                (new_cs + self.eps) / (total + self.codebook_size
                                       * self.eps) * total,
                jnp.ones_like(new_cs))
            new_embed = new_avg / jnp.maximum(smoothed, self.eps)[:, None]
            dead = new_cs < self.threshold_ema_dead_code
            refresh = flat[jnp.arange(self.codebook_size)
                           % flat.shape[0]]
            new_embed = jnp.where(dead[:, None], refresh, new_embed)
            new_avg = jnp.where(dead[:, None], new_embed, new_avg)
            new_cs = jnp.where(dead, self.threshold_ema_dead_code, new_cs)
            embed.value, embed_avg.value = new_embed, new_avg
            cluster_size.value = new_cs

        quantize = quantize.reshape(x.shape)
        if train:
            quantize = x + jax.lax.stop_gradient(quantize - x)
        commit = ((jax.lax.stop_gradient(quantize) - x) ** 2).mean()
        return quantize, ind.reshape(x.shape[:-1]), \
            commit * self.commitment_weight


class ResidualVectorQuant(nn.Module):
    """Residual VQ stack (reference nodeid.py:104-147)."""

    dim: int
    codebook_size: int
    num_res_layers: int = 3
    commitment_weight: float = 0.25
    decay: float = 0.8

    @nn.compact
    def __call__(self, x, train=False):
        total, out, inds = 0.0, 0.0, []
        residual = x
        for i in range(self.num_res_layers):
            q, ind, loss = VectorQuantize(
                self.dim, self.codebook_size,
                commitment_weight=self.commitment_weight,
                decay=self.decay, name=f"vq{i}")(residual, train)
            total = total + loss
            inds.append(ind)
            out = out + q
            residual = residual - q
        return out, inds, total


class NodeIDModel(nn.Module):
    """NodeID (reference nodeid.py:150-256): local GNN layers with
    per-layer residual vector quantization producing compact node IDs.
    Returns (logits, commit_loss, code_ids, gnn_id_logits)."""

    in_channels: int
    hidden_channels: int
    out_channels: int
    local_layers: int = 3
    dropout: float = 0.5
    heads: int = 1
    pre_ln: bool = False
    num_codes: int = 16
    gnn: str = "gat"

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        if num_nodes is None:
            num_nodes = x.shape[0]
        hidden = self.hidden_channels * self.heads
        drop = nn.Dropout(self.dropout, deterministic=not train)
        x = drop(nn.Dense(hidden, name="lin_in")(x))

        ids, commit, x_local = [], 0.0, 0.0
        for i in range(self.local_layers):
            if self.pre_ln:
                x = nn.LayerNorm(name=f"pre_ln{i}")(x)
            if self.gnn == "gat":
                conv = GATConv(self.hidden_channels, heads=self.heads,
                               dropout_rate=self.dropout, add_bias=False,
                               name=f"conv{i}")
                h = conv(x, edge_index, num_nodes=num_nodes, train=train)
            else:
                h = GCNConv(hidden, name=f"conv{i}")(
                    x, edge_index, num_nodes=num_nodes)
            x = h + nn.Dense(hidden, name=f"lin{i}")(x)
            x = drop(nn.relu(x))
            x_local = x_local + x
            _, code_inds, loss = ResidualVectorQuant(
                hidden, self.num_codes, name=f"rvq{i}")(x, train)
            ids.append(jnp.stack(code_inds, axis=1))
            commit = commit + loss

        ids = jnp.concatenate(ids, axis=1)
        gnn_id = nn.Dense(self.local_layers * 3, name="linear_gnn")(x_local)
        logits = nn.Dense(self.out_channels, name="pred_local")(x_local)
        return logits, commit, ids, gnn_id


def odeint_rk4(func, y0, t0, t1, num_steps=8):
    """Fixed-step RK4 integrator as a `lax.scan` (stand-in for
    the reference's torchdiffeq adapters, gnrf.py:26-198). Differentiable
    through the solver (discretize-then-optimize)."""
    dt = (t1 - t0) / num_steps

    def step(y, i):
        t = t0 + i * dt
        k1 = func(t, y)
        k2 = func(t + dt / 2, y + dt * k1 / 2)
        k3 = func(t + dt / 2, y + dt * k2 / 2)
        k4 = func(t + dt, y + dt * k3)
        return y + dt * (k1 + 2 * k2 + 2 * k3 + k4) / 6, None

    y, _ = jax.lax.scan(step, y0, jnp.arange(num_steps))
    return y


class _GNRFFunc(nn.Module):
    """dH/dt of the neural repulsion-field (reference gnrf.py:219-288):
    per-edge curvature scales the neighbor difference; `damping` works on
    the unit sphere with tangential projection."""

    hidden: int
    edgenet: bool = True
    channel_curv: bool = False
    damping: bool = False

    def _mlp(self, name, out):
        return nn.Sequential([nn.Dense(self.hidden), nn.relu,
                              nn.Dense(out)], name=name)

    @nn.compact
    def __call__(self, H, edge_index, num_nodes):
        eps = 1e-8
        if self.damping:
            H = H / jnp.sqrt((H ** 2).sum(1, keepdims=True) + eps)
        src, dst = edge_index[0], edge_index[1]
        H_i = jnp.take(H, src, axis=0, mode="clip")
        H_j = jnp.take(H, dst, axis=0, mode="clip")
        if self.edgenet:
            curv = nn.relu(self._mlp("mlp_1", self.hidden)(
                jnp.concatenate([H_i, H_j], axis=1)))
            curv = segment_sum(curv, src, num_nodes)
            curv = jnp.concatenate(
                [jnp.take(curv, src, axis=0, mode="clip"),
                 jnp.take(curv, dst, axis=0, mode="clip")], axis=1)
            out_dim = self.hidden if self.channel_curv else 1
            # Bound curvature to (0, 1) -- the reference's scalar branch
            # clips to (eps, 1] (gnrf.py:275); its unbounded edgenet output
            # relies on an adaptive solver, which a fixed-step RK4 cannot
            # tolerate (the dynamics go stiff and overflow fp32).
            curv = jax.nn.sigmoid(self._mlp("mlp_2", out_dim)(curv))
        else:
            a = self.param("a", nn.initializers.constant(0.5), ())
            curv = jnp.clip(a, eps, 1.0) * jnp.ones((H_i.shape[0], 1),
                                                    H.dtype)
        if self.damping:
            cos = (H_i * H_j).sum(1, keepdims=True)
            H_edge = curv * (H_j - cos * H_i)
        else:
            H_edge = curv * (H_j - H_i)
        dH = segment_mean(H_edge, src, num_nodes)
        if self.damping:
            dH = dH / jnp.sqrt((dH ** 2).sum(1, keepdims=True) + eps)
        return dH


class GNRFModel(nn.Module):
    """Graph neural repulsion field (reference gnrf.py:292-372):
    encoder -> ODE solve of the repulsion dynamics -> classifier head."""

    num_class: int
    hidden: int = 64
    edgenet: bool = True
    channel_curv: bool = False
    damping: bool = False
    t_end: float = 1.0
    num_steps: int = 8
    dropout: float = 0.2

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        if num_nodes is None:
            num_nodes = x.shape[0]
        drop = nn.Dropout(self.dropout, deterministic=not train)
        h = nn.relu(nn.Dense(self.hidden, name="lin_in")(drop(x)))
        ode = _GNRFFunc(self.hidden, self.edgenet, self.channel_curv,
                        self.damping, name="ode_block")
        # Python-unrolled RK4 (flax params cannot be created inside a
        # lax.scan body; num_steps is small so unrolling is cheap)
        dt = self.t_end / self.num_steps
        func = lambda y: ode(y, edge_index, num_nodes)  # noqa: E731
        for _ in range(self.num_steps):
            k1 = func(h)
            k2 = func(h + dt * k1 / 2)
            k3 = func(h + dt * k2 / 2)
            k4 = func(h + dt * k3)
            h = h + dt * (k1 + 2 * k2 + 2 * k3 + k4) / 6
        return nn.Dense(self.num_class, name="lin_out")(drop(nn.relu(h)))


def grace_pot_bounds(edge_index_np, num_nodes, local_changes=5):
    """Entry-wise adjacency-perturbation bounds for the POT certificate
    (reference grace_pot.py:118-133): A_upper from worst-case degree
    deletion, A_lower = diagonal of the normalized adjacency. Host-side
    numpy precompute; returns dense (N, N) float32 arrays."""
    import numpy as np
    src, dst = np.asarray(edge_index_np)
    und = np.concatenate([np.stack([src, dst]), np.stack([dst, src])],
                         axis=1)
    deg = np.bincount(und[1], minlength=num_nodes).astype(np.float64) / 2
    A = np.zeros((num_nodes, num_nodes), np.float32)
    A[src, dst] = 1.0
    A_tilde = A + np.eye(num_nodes, dtype=np.float32)
    degs_tilde = deg + 1
    max_delete = np.maximum(degs_tilde.astype(int) - 2, 0)
    max_delete = np.minimum(max_delete, np.round(local_changes * deg))
    s = 1 / np.sqrt(degs_tilde - max_delete)
    A_upper = np.where(A_tilde > 0, s * s[:, None], 0.0).astype(np.float32)
    # lower bound keeps only the self-loop terms of the gcn-normalized adj
    deg_sl = deg + 1
    A_lower = np.diag((1 / deg_sl).astype(np.float32))
    return A_upper, A_lower


class GracePOTModel(nn.Module):
    """GRACE-POT (reference grace_pot.py:36-190): GRACE encoder/projector
    plus a provable-robustness (CROWN-style) POT score. The full
    certificate pipeline is exposed via `pot_score` on dense bound
    matrices from `grace_pot_bounds`; the contrastive objective reuses
    `grace_loss`."""

    num_hidden: int
    num_proj_hidden: int
    tau: float = 0.5
    k: int = 2

    def setup(self):
        self.convs = [GCNConv(self.num_hidden if i == self.k - 1
                              else 2 * self.num_hidden, name=f"conv{i}")
                      for i in range(self.k)]
        self.fc1 = nn.Dense(self.num_proj_hidden)
        self.fc2 = nn.Dense(self.num_hidden)

    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None):
        h = x
        for conv in self.convs:
            h = nn.relu(conv(h, edge_index, edge_weight, num_nodes))
        return h

    def project(self, z):
        return self.fc2(nn.elu(self.fc1(z)))

    def loss(self, x1, ei1, w1, x2, ei2, w2, num_nodes=None):
        z1 = self(x1, ei1, w1, num_nodes)
        z2 = self(x2, ei2, w2, num_nodes)
        return grace_loss(self.project(z1), self.project(z2), self.tau)

    @staticmethod
    def pot_score(z2, A_add, A_sub, XW, HW):
        """Linear-relaxation POT score on a node subset (reference
        grace_pot.py:106-190, ReLU activation => alpha=0). `A_add`/`A_sub`
        are (B, B) dense (upper+lower)/2 and (upper-lower)/2 bound
        matrices over the subset; XW / HW the pre-activation features."""
        z1_U = A_add @ XW + A_sub @ jnp.abs(XW)
        z1_L = A_add @ XW - A_sub @ jnp.abs(XW)
        z2_U = A_add @ HW + A_sub @ jnp.abs(HW)
        z2_L = A_add @ HW - A_sub @ jnp.abs(HW)

        def alpha_beta(low, up):
            pos = low >= 0
            neg = up <= 0
            mid = ~(pos | neg)
            denom = jnp.where(mid, up - low, 1.0)
            a_mid = up / denom
            alpha = jnp.where(pos, 1.0, jnp.where(mid, a_mid, 0.0))
            beta_u = jnp.where(mid, -up * low / jnp.maximum(up, 1e-12),
                               0.0)
            return alpha, beta_u

        n = z2.shape[0]
        z2n = z2 / (jnp.linalg.norm(z2, axis=1, keepdims=True) + 1e-12)
        Wcl = z2n * (n / (n - 1)) - z2n.sum(0) / (n - 1)
        a2, b2 = alpha_beta(z2_L, z2_U)
        lam2 = jnp.where(Wcl >= 0, a2, a2)
        Lam2 = lam2 * Wcl
        a1, _ = alpha_beta(z1_L, z1_U)
        score = (Lam2 * (a1 * z1_U + b2)).sum(axis=1)
        return score

    @staticmethod
    def pot_loss(score):
        """Certificate hinge: push POT scores positive (reference
        grace_pot.py:188-189 sigmoid-CE against all-ones)."""
        return -jax.nn.log_sigmoid(score).mean()


class GraceSpcoModel(nn.Module):
    """GRACE-Spco (reference grace_spco.py:41-104): GRACE with
    edge-weighted views produced by the spectral-contrast schedule; the
    encoder threads `edge_attr` weights through each GCN layer."""

    num_hidden: int
    num_proj_hidden: int
    tau: float = 0.5
    k: int = 2

    @nn.compact
    def __call__(self, x1, ei1, w1, x2=None, ei2=None, w2=None,
                 num_nodes=None):
        convs = [GCNConv(self.num_hidden if i == self.k - 1
                         else 2 * self.num_hidden, name=f"conv{i}")
                 for i in range(self.k)]

        def encode(h, ei, w):
            for conv in convs:
                h = nn.relu(conv(h, ei, w, num_nodes))
            return h

        z1 = encode(x1, ei1, w1)
        if x2 is None:
            return z1
        z2 = encode(x2, ei2, w2)
        proj = nn.Sequential([nn.Dense(self.num_proj_hidden), nn.elu,
                              nn.Dense(self.num_hidden)])
        return grace_loss(proj(z1), proj(z2), self.tau)
