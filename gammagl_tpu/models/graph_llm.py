"""Graph-LLM models: GraphGPT-style CLIP pretraining + graph-token
injection, LLaGA node-sequence encoding.

Reference: gammagl/models/graphgpt.py:1-903 (CLIP graph-text contrastive
:178, GraphLlamaModel graph-token splicing :354+) and llaga.py. The LLM
backbone is decoupled: these modules produce/inject graph embeddings into
any embedding-space language model (pass the LM's token-embedding matrix or
an `embed_fn`), so tests run without a multi-GB checkpoint while a real
Llama (via `transformers`) drops in unchanged.
"""

from typing import Callable, Optional, Sequence

import numpy as np
from gammagl_tpu import nn
import jax
import jax.numpy as jnp

from gammagl_tpu.layers.conv import GCNConv
from gammagl_tpu.utils.gfm_utils import GRAPH_TOKEN_INDEX

__all__ = ["GraphTextCLIP", "GraphLlamaAdapter", "LLaGAEncoder",
           "splice_graph_embeddings", "TinyCausalLM", "GraphLlamaLM",
           "build_stage2_batch", "llaga_hop_field",
           "llaga_neighborhood_detail", "LLaGAProjector"]


class _TextTransformer(nn.Module):
    width: int
    layers: int
    heads: int
    vocab_size: int
    context_length: int

    @nn.compact
    def __call__(self, token_ids):
        # token_ids: (B, L)
        emb = nn.Embed(self.vocab_size, self.width,
                       embedding_init=nn.initializers.normal(0.02))
        pos = self.param("positional_embedding",
                         nn.initializers.normal(0.01),
                         (self.context_length, self.width))
        h = emb(token_ids) + pos[None, :token_ids.shape[1]]
        mask = nn.make_causal_mask(token_ids)
        for _ in range(self.layers):
            attn = nn.SelfAttention(num_heads=self.heads,
                                    qkv_features=self.width,
                                    deterministic=True)(
                nn.LayerNorm()(h), mask=mask)
            h = h + attn
            h = h + nn.Dense(self.width)(nn.gelu(nn.Dense(
                4 * self.width)(nn.LayerNorm()(h))))
        return nn.LayerNorm()(h)


class GraphTextCLIP(nn.Module):
    """CLIP-style graph-text contrastive pretraining (reference
    graphgpt.py:178): GNN node embeddings vs transformer text embeddings
    aligned with a symmetric InfoNCE."""

    embed_dim: int = 128
    gnn_hidden: int = 128
    transformer_width: int = 128
    transformer_layers: int = 2
    transformer_heads: int = 4
    vocab_size: int = 32000
    context_length: int = 64
    tau: float = 0.07

    @nn.compact
    def __call__(self, x, edge_index, node_ids, token_ids,
                 num_nodes=None):
        """node_ids: (B,) nodes paired with token_ids (B, L) descriptions."""
        h = nn.relu(GCNConv(self.gnn_hidden)(x, edge_index,
                                             num_nodes=num_nodes))
        h = GCNConv(self.embed_dim)(h, edge_index, num_nodes=num_nodes)
        g_emb = h[node_ids]
        t_h = _TextTransformer(self.transformer_width,
                               self.transformer_layers,
                               self.transformer_heads, self.vocab_size,
                               self.context_length)(token_ids)
        text_proj = self.param("text_projection",
                               nn.initializers.normal(
                                   self.transformer_width ** -0.5),
                               (self.transformer_width, self.embed_dim))
        t_emb = t_h[:, -1] @ text_proj  # EOT pooling

        g = g_emb / (jnp.linalg.norm(g_emb, axis=-1, keepdims=True) + 1e-8)
        t = t_emb / (jnp.linalg.norm(t_emb, axis=-1, keepdims=True) + 1e-8)
        logits = g @ t.T / self.tau
        labels = jnp.arange(logits.shape[0])
        import optax
        loss = (optax.softmax_cross_entropy_with_integer_labels(
                    logits, labels).mean()
                + optax.softmax_cross_entropy_with_integer_labels(
                    logits.T, labels).mean()) / 2
        return loss, (g_emb, t_emb)


class GraphLlamaAdapter(nn.Module):
    """Graph encoder + projector into an LM's hidden space (reference
    GraphLlamaModel.graph_projector :543). The LM itself is external."""

    lm_hidden_size: int
    graph_hidden_size: int = 128

    @nn.compact
    def __call__(self, x, edge_index, num_nodes=None):
        h = nn.relu(GCNConv(self.graph_hidden_size)(
            x, edge_index, num_nodes=num_nodes))
        h = GCNConv(self.graph_hidden_size)(h, edge_index,
                                            num_nodes=num_nodes)
        return nn.Dense(self.lm_hidden_size, name="graph_projector")(h)


class LLaGAEncoder(nn.Module):
    """LLaGA (Chen 2024; reference llaga.py): encode each target node as a
    fixed template of neighborhood features (hop-field or neighborhood-
    detail), projected into the LM hidden space."""

    lm_hidden_size: int
    num_hops: int = 2
    sample_size: int = 10

    @nn.compact
    def __call__(self, hop_features):
        """hop_features: (B, num_hops + 1, F) mean-pooled per-hop features
        (precomputed host-side from sampled neighborhoods)."""
        h = nn.Dense(2 * self.lm_hidden_size)(hop_features)
        h = nn.gelu(h)
        return nn.Dense(self.lm_hidden_size)(h)  # (B, hops+1, H) tokens


def splice_graph_embeddings(input_ids, token_embeds, graph_embeds,
                            graph_token_index=GRAPH_TOKEN_INDEX):
    """Replace sentinel positions in a token sequence with graph embeddings
    (reference GraphLlamaModel.forward :582 splicing loop).

    input_ids: (L,) ints with `graph_token_index` sentinels (k of them)
    token_embeds: (L, H) embeddings from the LM for every position
    graph_embeds: (k, H) embeddings to inject, in order
    """
    input_ids = jnp.asarray(input_ids)
    is_graph = input_ids == graph_token_index
    # position among sentinels for each location (0-based)
    slot = jnp.cumsum(is_graph) - 1
    slot = jnp.clip(slot, 0, graph_embeds.shape[0] - 1)
    return jnp.where(is_graph[:, None], graph_embeds[slot], token_embeds)


class TinyCausalLM(nn.Module):
    """Small causal LM with a tied embedding head — the drop-in test/demo
    backbone for the GraphGPT/LLaGA stage-2 path. A real Llama via
    `transformers` exposes the same two surfaces used here (token
    embedding table + logits head), so the splice/training code is
    backbone-agnostic.
    """

    vocab_size: int = 512
    hidden: int = 64
    layers: int = 2
    heads: int = 4
    max_len: int = 128

    def setup(self):
        self.tok = nn.Embed(self.vocab_size, self.hidden,
                            embedding_init=nn.initializers.normal(0.02))
        self.pos = self.param("pos", nn.initializers.normal(0.01),
                              (self.max_len, self.hidden))
        self.blocks = [
            {"ln1": nn.LayerNorm(), "attn": nn.SelfAttention(
                num_heads=self.heads, qkv_features=self.hidden,
                deterministic=True),
             "ln2": nn.LayerNorm(), "up": nn.Dense(4 * self.hidden),
             "down": nn.Dense(self.hidden)}
            for _ in range(self.layers)]
        self.ln_f = nn.LayerNorm()

    def embed(self, input_ids):
        """Token-embedding lookup (sentinels must be clipped out first)."""
        return self.tok(input_ids)

    def forward_embeds(self, h):
        """(B, L, H) input embeddings -> (B, L, V) logits; causal."""
        L = h.shape[1]
        h = h + self.pos[None, :L]
        mask = nn.make_causal_mask(jnp.zeros(h.shape[:2], jnp.int32))
        for blk in self.blocks:
            h = h + blk["attn"](blk["ln1"](h), mask=mask)
            h = h + blk["down"](nn.gelu(blk["up"](blk["ln2"](h))))
        h = self.ln_f(h)
        return h @ self.tok.embedding.T  # tied head

    def __call__(self, input_ids):
        return self.forward_embeds(self.embed(input_ids))


class GraphLlamaLM(nn.Module):
    """GraphGPT stage-2 model: LM + graph adapter + sentinel splicing
    (reference graphgpt.py GraphLlamaModel.forward:582 — graph-token
    positions in the prompt are replaced by projected node embeddings
    before the LM runs; CE loss on response tokens only).

    `__call__(x, edge_index, node_ids, input_ids, labels)`:
      x/edge_index: the graph; node_ids (B, K) nodes whose embeddings
      fill the K graph-token sentinels of each row of input_ids (B, L);
      labels (B, L) with IGNORE_INDEX on prompt/pad/graph positions.
    """

    vocab_size: int = 512
    lm_hidden: int = 64
    graph_hidden: int = 64
    lm_layers: int = 2
    max_len: int = 128

    def setup(self):
        self.lm = TinyCausalLM(vocab_size=self.vocab_size,
                               hidden=self.lm_hidden,
                               layers=self.lm_layers,
                               max_len=self.max_len)
        self.adapter = GraphLlamaAdapter(
            lm_hidden_size=self.lm_hidden,
            graph_hidden_size=self.graph_hidden)

    def __call__(self, x, edge_index, node_ids, input_ids, labels=None,
                 num_nodes=None):
        from gammagl_tpu.utils.gfm_utils import (GRAPH_TOKEN_INDEX,
                                                 IGNORE_INDEX)
        g_emb = self.adapter(x, edge_index, num_nodes=num_nodes)  # (N, H)
        safe_ids = jnp.where(input_ids == GRAPH_TOKEN_INDEX, 0,
                             input_ids)
        tok = self.lm.embed(safe_ids)                         # (B, L, H)
        spliced = jax.vmap(
            lambda ids, te, nid: splice_graph_embeddings(
                ids, te, g_emb[nid]))(input_ids, tok, node_ids)
        logits = self.lm.forward_embeds(spliced)
        if labels is None:
            return logits
        # next-token CE over positions whose TARGET label is real
        import optax
        tgt = labels[:, 1:]
        lg = logits[:, :-1]
        keep = (tgt != IGNORE_INDEX).astype(jnp.float32)
        ls = optax.softmax_cross_entropy_with_integer_labels(
            lg, jnp.maximum(tgt, 0))
        return (ls * keep).sum() / jnp.maximum(keep.sum(), 1.0), logits


def build_stage2_batch(prompts, responses, tokenizer, num_graph_tokens,
                       max_len):
    """Host-side tokenize + pad for the stage-2 splice path (reference
    graphgpt stage-2 data collator): each prompt contains one
    ``<graph>`` placeholder that expands to `num_graph_tokens`
    sentinels; labels are IGNORE_INDEX on prompt/graph/pad positions
    and the token ids on the response.

    Returns (input_ids, labels) int32 arrays of shape (B, max_len).
    """
    from gammagl_tpu.utils.gfm_utils import (DEFAULT_GRAPH_TOKEN,
                                             GRAPH_TOKEN_INDEX,
                                             IGNORE_INDEX)
    B = len(prompts)
    ids = np.zeros((B, max_len), np.int32)
    labels = np.full((B, max_len), IGNORE_INDEX, np.int32)
    for b, (p, r) in enumerate(zip(prompts, responses)):
        pre, _, post = p.partition(DEFAULT_GRAPH_TOKEN)
        seq = (tokenizer(pre)
               + [GRAPH_TOKEN_INDEX] * num_graph_tokens
               + tokenizer(post))
        resp = tokenizer(r)
        lab = [IGNORE_INDEX] * len(seq) + resp
        seq = (seq + resp)[:max_len]
        lab = lab[:max_len]
        ids[b, :len(seq)] = seq
        labels[b, :len(lab)] = lab
    return ids, labels


# -- LLaGA structure-aware templates (reference llaga.py) ----------------

def llaga_hop_field(x, edge_index, nodes, num_hops=2):
    """Hop-field (HO) template: per target node, mean-pooled features of
    each hop ring 0..num_hops -> (B, num_hops+1, F) (reference llaga
    hop-field encoding; consumed by `LLaGAEncoder`)."""
    x = np.asarray(x)
    ei = np.asarray(edge_index)
    n = x.shape[0]
    adj = [[] for _ in range(n)]
    for s, d in ei.T:
        adj[int(d)].append(int(s))
    out = np.zeros((len(nodes), num_hops + 1, x.shape[1]), np.float32)
    for b, v in enumerate(np.asarray(nodes)):
        frontier = {int(v)}
        seen = {int(v)}
        out[b, 0] = x[int(v)]
        for hop in range(1, num_hops + 1):
            nxt = set()
            for u in frontier:
                nxt.update(adj[u])
            nxt -= seen
            if nxt:
                out[b, hop] = x[sorted(nxt)].mean(0)
            seen |= nxt
            frontier = nxt
    return out


def llaga_neighborhood_detail(edge_index, nodes, num_nodes, use_hop=2,
                              sample_size=3, seed=0):
    """Neighborhood-detail (ND) template: fixed-shape sampled neighbor
    TREE per target node — sample_size^i slots at hop i, total
    (s^(h+1)-1)/(s-1) ids, missing slots = DEFAULT_GRAPH_PAD_ID
    (reference llaga.py:99-101 asserts exactly this layout; pads embed
    to zero in `encode_graphs`:93-96)."""
    from gammagl_tpu.utils.gfm_utils import DEFAULT_GRAPH_PAD_ID
    ei = np.asarray(edge_index)
    rng = np.random.default_rng(seed)
    adj = [[] for _ in range(num_nodes)]
    for s, d in ei.T:
        adj[int(d)].append(int(s))
    total = (sample_size ** (use_hop + 1) - 1) // (sample_size - 1)
    out = np.full((len(np.asarray(nodes)), total), DEFAULT_GRAPH_PAD_ID,
                  np.int64)
    for b, v in enumerate(np.asarray(nodes)):
        layer = [int(v)]
        out[b, 0] = int(v)
        cur = 1
        for hop in range(1, use_hop + 1):
            nxt = []
            for u in layer:
                if u == DEFAULT_GRAPH_PAD_ID or not adj[u]:
                    nxt.extend([DEFAULT_GRAPH_PAD_ID] * sample_size)
                    continue
                nbrs = adj[u]
                pick = (rng.choice(nbrs, sample_size, replace=False)
                        if len(nbrs) >= sample_size
                        else np.concatenate([
                            nbrs, np.full(sample_size - len(nbrs),
                                          DEFAULT_GRAPH_PAD_ID)]))
                nxt.extend(int(p) for p in pick)
            out[b, cur:cur + len(nxt)] = nxt
            cur += len(nxt)
            layer = nxt
    return out


class LLaGAProjector(nn.Module):
    """ND-template projector with hop-separator special tokens
    (reference llaga.py `inject_special_token`:98-112): project sampled
    node embeddings, zero the PAD slots, interleave use_hop+2 learned
    special tokens between hop groups."""

    lm_hidden_size: int
    use_hop: int = 2
    sample_size: int = 3

    @nn.compact
    def __call__(self, node_seq, node_feats):
        """node_seq (B, T) ids with DEFAULT_GRAPH_PAD_ID; node_feats
        (N, F). Returns (B, T + use_hop + 2, H) graph tokens."""
        from gammagl_tpu.utils.gfm_utils import DEFAULT_GRAPH_PAD_ID
        s, h = self.sample_size, self.use_hop
        total = (s ** (h + 1) - 1) // (s - 1)
        proj = nn.Sequential([
            nn.Dense(2 * self.lm_hidden_size), nn.gelu,
            nn.Dense(self.lm_hidden_size)])
        special = self.param("special_token_emb",
                             nn.initializers.normal(0.02),
                             (h + 2, self.lm_hidden_size))
        feats = jnp.take(node_feats,
                         jnp.maximum(node_seq, 0), axis=0)
        g = proj(feats)
        g = jnp.where((node_seq == DEFAULT_GRAPH_PAD_ID)[..., None],
                      0.0, g)
        parts = [jnp.broadcast_to(special[0],
                                  (g.shape[0], 1, g.shape[-1]))]
        cur = 0
        for i in range(h + 1):
            size = s ** i
            parts.append(g[:, cur:cur + size])
            cur += size
            parts.append(jnp.broadcast_to(
                special[i + 1], (g.shape[0], 1, g.shape[-1])))
        assert cur == total
        return jnp.concatenate(parts, axis=1)
