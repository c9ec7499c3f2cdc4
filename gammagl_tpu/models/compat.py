"""Reference-name model classes and aliases.

GammaGL (the reference) exports many models under names that differ from
this framework's primary names (`gammagl/models/__init__.py:1-74`). This
module closes the naming gap so a reference user finds every export, and
implements the handful of models that had no counterpart yet (AGNN, FiLM,
GMM, DNA, HCHA node-classification stacks; Sp2GCL's SpaSpeNode/Encoder/
EigenMLP; SkipGram; DFAD student/generator; GCIL LogReg; AdaGAD ReModel;
the AMP ELBO regression loss).

Aliases are plain name bindings — this package's implementation is the
single source of truth; nothing here forks behavior.
"""

import jax
import jax.numpy as jnp
from gammagl_tpu import nn
import numpy as np

from gammagl_tpu.layers.conv import (AGNNConv, DNAConv, FILMConv, GCNConv,
                                     GMMConv, HypergraphConv)
from gammagl_tpu.layers.conv.compat_convs import FusedGATConv
from gammagl_tpu.models.gcn import GCNModel
from gammagl_tpu.models.gat import GATModel  # noqa: F401 (re-export base)
from gammagl_tpu.models.graphsage import (GraphSAGEModel,
                                          GraphSAGESampleModel)
from gammagl_tpu.models.hetero import RGCNModel, HANModel
from gammagl_tpu.models.embedding import DeepWalk, Node2Vec
from gammagl_tpu.models.wave2_models import CompGCNModel
from gammagl_tpu.models.wave3_models import (GRADEModel, HPNModel,
                                             RoheHANModel, HiDNetModel,
                                             tadw)
from gammagl_tpu.models.spectral import SpecformerModel, MGNNIModel
from gammagl_tpu.models.heco import HeCoModel
from gammagl_tpu.models.gan_distill import herec
from gammagl_tpu.models.wave5_models import AdaGADModel
from gammagl_tpu.models.wave6_models import (MAGCLModel, EdgePromptModel,
                                             dfad_generator_loss,
                                             dfad_student_loss)
from gammagl_tpu.models.wave7_models import (HEATModel, NodeIDModel,
                                             GNRFModel)
from gammagl_tpu.models.wave8_models import GraphEditer
from gammagl_tpu.models.seal_cogsl import SEALModel
from gammagl_tpu.models.graphormer import GraphormerModel

__all__ = [
    # pure aliases
    "HEAT", "GraphSAGE_Full_Model", "GraphSAGE_Sample_Model", "RGCN",
    "CompGCN", "HAN", "GRADE", "HPN", "HeCo", "Hid_net", "RoheHAN",
    "Graphormer", "Specformer", "NewGrace", "NodeIDGNN", "GNRF",
    "DeepWalkModel", "Node2vecModel", "Graph_Editer", "DGCNN",
    "PreModel", "EdgePromptGCNModel", "MGNNI_m_MLP",
    # thin real models
    "AGNNModel", "FILMModel", "GMMModel", "DNAModel", "HCHA", "LogReg",
    "SkipGramModel", "HERec", "TADWModel", "MGNNI_m_att", "DFADModel",
    "DFADGenerator", "Generator", "Discriminator", "EigenMLP", "Encoder",
    "SpaSpeNode", "ReModel", "EdgePromptNodeClassifier", "FusedGATModel",
    "GNN", "amp_elbo_regression_loss",
]

# --- pure aliases (reference name -> this package's class) --------------
HEAT = HEATModel
GraphSAGE_Full_Model = GraphSAGEModel
GraphSAGE_Sample_Model = GraphSAGESampleModel
RGCN = RGCNModel
CompGCN = CompGCNModel
HAN = HANModel
GRADE = GRADEModel
HPN = HPNModel
HeCo = HeCoModel
Hid_net = HiDNetModel
RoheHAN = RoheHANModel
Graphormer = GraphormerModel
Specformer = SpecformerModel
NewGrace = MAGCLModel                 # reference magcl.py names it NewGrace
NodeIDGNN = NodeIDModel
GNRF = GNRFModel
DeepWalkModel = DeepWalk
Node2vecModel = Node2Vec
Graph_Editer = GraphEditer
DGCNN = SEALModel                     # reference seal.py exports DGCNN
PreModel = AdaGADModel                # AdaGAD masked-recon pretrainer
EdgePromptGCNModel = EdgePromptModel
MGNNI_m_MLP = MGNNIModel              # MLP-injection multiscale variant


# --- small node-classification stacks over existing convs ----------------
class AGNNModel(nn.Module):
    """AGNN (reference agnn.py): Dense -> k AGNNConv -> Dense."""

    num_class: int
    hidden_dim: int = 16
    n_att_layers: int = 2
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        h = nn.relu(nn.Dense(self.hidden_dim)(drop(x)))
        for _ in range(self.n_att_layers):
            h = AGNNConv()(h, edge_index, num_nodes=num_nodes)
        return nn.Dense(self.num_class)(drop(h))


class FILMModel(nn.Module):
    """GNN-FiLM (reference film.py): stacked FILMConv + linear head."""

    num_class: int
    hidden_dim: int = 64
    num_layers: int = 2
    drop_rate: float = 0.1

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        h = x
        for _ in range(self.num_layers):
            h = drop(FILMConv(self.hidden_dim)(h, edge_index,
                                               num_nodes=num_nodes))
        return nn.Dense(self.num_class)(h)


class GMMModel(nn.Module):
    """MoNet (reference gmm.py): GMMConv stack with degree-based
    pseudo-coordinates u_ij = (1/sqrt(deg_i), 1/sqrt(deg_j))."""

    num_class: int
    hidden_dim: int = 16
    kernel_size: int = 3

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        from gammagl_tpu.utils.degree import degree
        if num_nodes is None:
            num_nodes = x.shape[0]
        deg = degree(edge_index[1], num_nodes=num_nodes, dtype=x.dtype)
        dis = jnp.where(deg > 0, deg ** -0.5, 0.0)
        pseudo = jnp.stack([dis[edge_index[0]], dis[edge_index[1]]], -1)
        h = nn.relu(GMMConv(self.hidden_dim,
                            kernel_size=self.kernel_size)(
            x, edge_index, pseudo, num_nodes=num_nodes))
        return GMMConv(self.num_class, kernel_size=self.kernel_size)(
            h, edge_index, pseudo, num_nodes=num_nodes)


class DNAModel(nn.Module):
    """DNA (reference dna.py): per-layer DNAConv over the stack of all
    previous representations."""

    num_class: int
    hidden_dim: int = 64
    num_layers: int = 3
    heads: int = 1
    drop_rate: float = 0.5

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        h = nn.relu(nn.Dense(self.hidden_dim)(drop(x)))
        x_all = h[:, None]
        for _ in range(self.num_layers):
            h = DNAConv(heads=self.heads)(x_all, edge_index,
                                          num_nodes=num_nodes)
            x_all = jnp.concatenate([x_all, h[:, None]], axis=1)
        return nn.Dense(self.num_class)(drop(x_all[:, -1]))


class HCHA(nn.Module):
    """Hypergraph conv w/ attention model (reference hcha.py)."""

    num_class: int
    hidden_dim: int = 64

    @nn.compact
    def __call__(self, x, hyperedge_index, hyperedge_weight=None,
                 num_nodes=None, num_edges=None):
        h = nn.relu(HypergraphConv(self.hidden_dim)(
            x, hyperedge_index, hyperedge_weight, num_nodes, num_edges))
        return HypergraphConv(self.num_class)(
            h, hyperedge_index, hyperedge_weight, num_nodes, num_edges)


class FusedGATModel(nn.Module):
    """GAT over FusedGATConv layers (reference fusedgat.py wraps dgNN).
    Sort the edges once with ``FusedGATConv.to_graph_format``."""

    hidden_dim: int = 8
    num_class: int = 7
    heads: int = 8
    drop_rate: float = 0.6

    to_graph_format = staticmethod(FusedGATConv.to_graph_format)

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        drop = nn.Dropout(self.drop_rate, deterministic=not train)
        h = FusedGATConv(self.hidden_dim, heads=self.heads)(
            drop(x), edge_index, num_nodes, train=train)
        h = nn.elu(h)
        return FusedGATConv(self.num_class, heads=1, concat=False)(
            drop(h), edge_index, num_nodes, train=train)


# --- probes / heads -------------------------------------------------------
class LogReg(nn.Module):
    """Logistic-regression probe (reference gcil.py LogReg)."""

    out_dim: int

    @nn.compact
    def __call__(self, x):
        return nn.Dense(self.out_dim)(x)


class EdgePromptNodeClassifier(nn.Module):
    """Downstream head over frozen prompted embeddings (reference
    edgeprompt.py EdgePromptNodeClassifier)."""

    num_class: int
    hidden_dim: int = 64

    @nn.compact
    def __call__(self, h):
        return nn.Dense(self.num_class)(nn.relu(
            nn.Dense(self.hidden_dim)(h)))


class ReModel(nn.Module):
    """AdaGAD retraining-stage scorer (reference adagad.py ReModel):
    fuses attribute/structure/subgraph reconstruction errors into one
    anomaly score with learnable mixture weights."""

    @nn.compact
    def __call__(self, errors):
        """errors: (N, K) stacked per-view reconstruction errors."""
        w = self.param("mix", nn.initializers.ones, (errors.shape[-1],))
        return errors @ jax.nn.softmax(w)


# --- embedding-table models -----------------------------------------------
class SkipGramModel(nn.Module):
    """Skip-gram over random walks (reference skipgram.py): positive
    window pairs vs negative samples, BCE on embedding dot products."""

    num_nodes: int
    embedding_dim: int = 128
    eps: float = 1e-15

    @nn.compact
    def __call__(self, pos_rw, neg_rw):
        emb = nn.Embed(self.num_nodes, self.embedding_dim)

        def walk_loss(rw, positive):
            h_start = emb(rw[:, 0])[:, None]            # (B, 1, D)
            h_rest = emb(rw[:, 1:])                     # (B, W, D)
            out = jnp.sum(h_start * h_rest, -1).reshape(-1)
            p = jax.nn.sigmoid(out)
            p = p if positive else 1.0 - p
            return -jnp.mean(jnp.log(p + self.eps))

        return walk_loss(pos_rw, True) + walk_loss(neg_rw, False)


class Generator(nn.Module):
    """GraphGAN generator half (reference graphgan_generator.py):
    embedding table + bias, policy-gradient loss against D's reward."""

    num_nodes: int
    embedding_dim: int = 64

    @nn.compact
    def __call__(self, u, v, reward):
        emb = self.param("emb", nn.initializers.normal(0.1),
                         (self.num_nodes, self.embedding_dim))
        bias = self.param("bias", nn.initializers.zeros, (self.num_nodes,))
        score = jnp.sum(emb[u] * emb[v], -1) + bias[v]
        logp = jax.nn.log_sigmoid(score)
        return -(logp * jax.lax.stop_gradient(reward)).mean()


class Discriminator(nn.Module):
    """GraphGAN discriminator half (reference graphgan_discriminator.py):
    sigmoid BCE on edge scores; exposes reward for the generator."""

    num_nodes: int
    embedding_dim: int = 64

    def setup(self):
        self.emb = self.param("emb", nn.initializers.normal(0.1),
                              (self.num_nodes, self.embedding_dim))
        self.bias = self.param("bias", nn.initializers.zeros,
                               (self.num_nodes,))

    def score(self, u, v):
        return jnp.sum(self.emb[u] * self.emb[v], -1) + self.bias[v]

    def reward(self, u, v):
        return jnp.log1p(jnp.exp(self.score(u, v)))

    def __call__(self, u, v, label):
        import optax
        return optax.sigmoid_binary_cross_entropy(
            self.score(u, v), label).mean()


# --- Sp2GCL components (reference sp2gcl.py) -------------------------------
class Encoder(nn.Module):
    """Sp2GCL spatial encoder: 2-layer GCN."""

    hidden_dim: int = 64

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None):
        h = nn.relu(GCNConv(self.hidden_dim)(x, edge_index,
                                             num_nodes=num_nodes))
        return GCNConv(self.hidden_dim)(h, edge_index,
                                        num_nodes=num_nodes)


class EigenMLP(nn.Module):
    """Sp2GCL spectral encoder: eigenvalue period features (sin/cos of
    scaled eigvals) modulating eigenvector channels."""

    hidden_dim: int = 64
    period: int = 16

    @nn.compact
    def __call__(self, eigvecs, eigvals):
        k = jnp.arange(1, self.period + 1, dtype=eigvals.dtype)
        ang = eigvals[:, None] * (2.0 ** (k - 1)) * jnp.pi   # (K, P)
        pe = jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], -1)
        lam = nn.Dense(self.hidden_dim)(nn.relu(
            nn.Dense(self.hidden_dim)(pe)))                  # (K, H)
        h = eigvecs @ lam                                    # (N, H)
        return nn.Dense(self.hidden_dim)(nn.relu(h))


class SpaSpeNode(nn.Module):
    """Sp2GCL pair: spatial GCN view vs spectral EigenMLP view with
    projection heads; returns (h_spatial, h_spectral)."""

    hidden_dim: int = 64
    period: int = 16

    @nn.compact
    def __call__(self, x, edge_index, eigvecs, eigvals, num_nodes=None):
        spa = Encoder(self.hidden_dim)(x, edge_index, num_nodes)
        spe = EigenMLP(self.hidden_dim, self.period)(eigvecs, eigvals)
        proj = nn.Sequential([nn.Dense(self.hidden_dim), nn.elu,
                              nn.Dense(self.hidden_dim)])
        return proj(spa), proj(spe)


# --- MGNNI attention variant ----------------------------------------------
class MGNNI_m_att(nn.Module):
    """MGNNI with attention over scales (reference mgnni.py MGNNI_m_att):
    per-scale equilibria combined by learned softmax attention instead of
    concatenation."""

    num_class: int
    hidden_dim: int = 64
    scales: tuple = (1, 2)
    gamma: float = 0.8
    iters: int = 10

    @nn.compact
    def __call__(self, x, edge_index, edge_weight=None, num_nodes=None,
                 train=False):
        from gammagl_tpu.layers.conv.compat_convs import MGNNI_m_iter
        if num_nodes is None:
            num_nodes = x.shape[0]
        fx = nn.Dense(self.hidden_dim)(x)
        zs = [MGNNI_m_iter(self.hidden_dim, k=m, gamma=self.gamma,
                           max_iter=self.iters)(
                  fx, edge_index, edge_weight, num_nodes)
              for m in self.scales]
        z = jnp.stack(zs, axis=1)                       # (N, S, H)
        att = nn.Dense(1)(jnp.tanh(nn.Dense(self.hidden_dim)(z)))
        z = jnp.sum(jax.nn.softmax(att, axis=1) * z, axis=1)
        return nn.Dense(self.num_class)(z)


# --- DFAD (data-free adversarial distillation) -----------------------------
class DFADModel(nn.Module):
    """DFAD student (reference dfad.py DFADModel): GCN student trained
    from teacher logits via L1 (losses in wave6_models)."""

    num_class: int
    hidden_dim: int = 64

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        return GCNModel(hidden_dim=self.hidden_dim,
                        num_class=self.num_class)(
            x, edge_index, num_nodes=num_nodes, train=train)

    @staticmethod
    def student_loss(student_logits, teacher_logits):
        return dfad_student_loss(student_logits, teacher_logits)


class DFADGenerator(nn.Module):
    """DFAD graph generator (reference dfad.py DFADGenerator): maps noise
    to node features + a dense (thresholdable) adjacency."""

    num_nodes_out: int
    feat_dim: int
    hidden_dim: int = 128

    @nn.compact
    def __call__(self, z):
        """z: (B, Z) noise; returns (node_feats (B,N,F), adj (B,N,N))."""
        h = nn.relu(nn.Dense(self.hidden_dim)(z))
        feats = nn.Dense(self.num_nodes_out * self.feat_dim)(h)
        feats = feats.reshape(-1, self.num_nodes_out, self.feat_dim)
        a = nn.Dense(self.num_nodes_out * self.num_nodes_out)(h)
        a = a.reshape(-1, self.num_nodes_out, self.num_nodes_out)
        adj = jax.nn.sigmoid((a + jnp.swapaxes(a, 1, 2)) / 2)
        return feats, adj

    @staticmethod
    def generator_loss(student_logits, teacher_logits):
        return dfad_generator_loss(student_logits, teacher_logits)


# --- GNRF backbone ----------------------------------------------------------
class GNN(nn.Module):
    """GNRF's plain GNN backbone (reference gnrf.py GNN): optional input
    MLP/BN, stacked GCN convs, residual tail."""

    num_class: int
    hidden_dim: int = 64
    num_layers: int = 2
    use_mlp_in: bool = False

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None, train=False):
        h = nn.Dense(self.hidden_dim)(x)
        if self.use_mlp_in:
            h = nn.Dense(self.hidden_dim)(nn.relu(h))
        for _ in range(self.num_layers):
            h = h + nn.relu(GCNConv(self.hidden_dim)(
                h, edge_index, num_nodes=num_nodes))
        return nn.Dense(self.num_class)(h)


# --- host-side embedding wrappers ------------------------------------------
class HERec:
    """HERec (reference herec.py): metapath2vec embeddings fused for
    recommendation. Class facade over the functional `herec` kernel."""

    def __init__(self, dim=64):
        self.dim = dim
        self.embeddings = None

    def fit(self, metapath_embeddings, ratings=None):
        self.embeddings = herec(metapath_embeddings, ratings=ratings,
                                dim=self.dim)
        return self.embeddings


class TADWModel:
    """TADW (reference tadw.py TADWModel): text-associated DeepWalk via
    matrix factorization. Class facade over the functional `tadw`."""

    def __init__(self, dim=80, lam=0.2, iters=20, lr=0.01, seed=0):
        self.kw = dict(dim=dim, lam=lam, iters=iters, lr=lr, seed=seed)
        self.embeddings = None

    def fit(self, adj, text_features):
        self.embeddings = tadw(np.asarray(adj), np.asarray(text_features),
                               **self.kw)
        return self.embeddings


# --- AMP ELBO loss ----------------------------------------------------------
def amp_elbo_regression_loss(output_state, targets, log_p_theta_hidden,
                             log_p_theta_output, log_p_L, entropy_qL,
                             qL_probs, n_obs):
    """Negative ELBO for AMP graph regression (reference amp.py:122-163).

    output_state: (num_graphs, num_layers, dim_target) per-depth preds;
    qL_probs: (1, num_layers) variational depth distribution.
    """
    targets = jnp.asarray(targets)
    output_state = jnp.asarray(output_state)
    if targets.ndim == 1:
        targets = targets[:, None]
    if output_state.ndim == 2:
        output_state = output_state[..., None]
    n_obs = jnp.asarray(n_obs, jnp.float32)
    se = jnp.sum((output_state - targets[:, None, :]) ** 2, axis=-1)
    log_p_y = (-jnp.mean(se, axis=0) / 2.0 * n_obs)[None, :]  # (1, L)
    elbo = log_p_y + log_p_theta_hidden + log_p_theta_output + log_p_L
    elbo = jnp.sum(elbo * qL_probs, axis=1) + entropy_qL
    return -jnp.mean(elbo / n_obs)
