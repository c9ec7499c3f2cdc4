"""LLaGA instruction tuning with structure-aware templates.

Reference: examples/llaga/ + gammagl/models/llaga.py (591 LoC): encode
each target node as a node-sequence template — hop-field (HO: pooled
per-hop features) or neighborhood-detail (ND: fixed sampled neighbor
tree with hop-separator special tokens, llaga.py:98-112) — project into
the LM hidden space, splice at <graph> sentinels, tune with CE on the
response. The reference shells out to gated Llama checkpoints; here the
same library pieces drive TinyCausalLM so the full training loop runs
offline, and a `transformers` Llama drops in by replacing the backbone.

Usage: python examples/llaga/llaga_trainer.py --template nd
"""

import os.path as osp
import sys

sys.path.insert(0, osp.join(osp.dirname(__file__), "..", ".."))

import numpy as np
import jax
import jax.numpy as jnp
import optax

from examples.common import base_parser, load_node_dataset
from gammagl_tpu.models import (LLaGAEncoder, LLaGAProjector, TinyCausalLM,
                                llaga_hop_field,
                                llaga_neighborhood_detail,
                                splice_graph_embeddings)
from gammagl_tpu.train import TrainState
from gammagl_tpu.utils.conversation import get_conv_template
from gammagl_tpu.utils.gfm_utils import (DEFAULT_GRAPH_TOKEN,
                                         GRAPH_TOKEN_INDEX, IGNORE_INDEX)

from gammagl_tpu import nn


def toy_tokenizer(s):
    return [2 + (ord(c) % 60) for c in s][:24]


class LLaGAModel(nn.Module):
    """Template encoder + TinyCausalLM with sentinel splicing."""

    num_graph_tokens: int
    template: str = "nd"
    vocab: int = 80
    hidden: int = 32
    use_hop: int = 2
    sample_size: int = 3

    def setup(self):
        self.lm = TinyCausalLM(vocab_size=self.vocab, hidden=self.hidden,
                               layers=1, max_len=96)
        if self.template == "nd":
            self.enc = LLaGAProjector(lm_hidden_size=self.hidden,
                                      use_hop=self.use_hop,
                                      sample_size=self.sample_size)
        else:
            self.enc = LLaGAEncoder(lm_hidden_size=self.hidden,
                                    num_hops=self.use_hop)

    def __call__(self, graph_inputs, input_ids, labels):
        if self.template == "nd":
            seq, feats = graph_inputs
            g_tokens = self.enc(seq, feats)       # (B, T, H)
        else:
            g_tokens = self.enc(graph_inputs)     # (B, hops+1, H)
        safe = jnp.where(input_ids == GRAPH_TOKEN_INDEX, 0, input_ids)
        tok = self.lm.embed(safe)
        spliced = jax.vmap(splice_graph_embeddings)(input_ids, tok,
                                                    g_tokens)
        logits = self.lm.forward_embeds(spliced)
        tgt, lg = labels[:, 1:], logits[:, :-1]
        keep = (tgt != IGNORE_INDEX).astype(jnp.float32)
        ls = optax.softmax_cross_entropy_with_integer_labels(
            lg, jnp.maximum(tgt, 0))
        return (ls * keep).sum() / jnp.maximum(keep.sum(), 1.0)


def main(args):
    rng = np.random.default_rng(args.seed)
    g, num_classes = load_node_dataset(args.dataset, args.dataset_path)
    x = np.asarray(g.x)[:, :16].astype(np.float32)
    ei = np.asarray(g.edge_index)
    y = np.asarray(g.y)
    n = x.shape[0]
    nodes = rng.permutation(n)[:args.batch_size]

    s, h = 3, 2
    if args.template == "nd":
        seq = llaga_neighborhood_detail(ei, nodes, n, use_hop=h,
                                        sample_size=s, seed=args.seed)
        K = seq.shape[1] + h + 2   # node slots + hop separators
        graph_inputs = (jnp.asarray(seq), jnp.asarray(x))
    else:
        hop = llaga_hop_field(x, ei, nodes, num_hops=h)
        K = h + 1
        graph_inputs = jnp.asarray(hop)

    # instruction pairs through the llaga template
    max_len = 96
    ids = np.zeros((len(nodes), max_len), np.int32)
    labels = np.full((len(nodes), max_len), IGNORE_INDEX, np.int32)
    for b, v in enumerate(nodes):
        conv = get_conv_template("llaga_llama_2")
        conv.append_message(conv.roles[0],
                            f"Node {DEFAULT_GRAPH_TOKEN} category?")
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()[-40:]
        pre, _, post = prompt.partition(DEFAULT_GRAPH_TOKEN)
        seq_ids = (toy_tokenizer(pre) + [GRAPH_TOKEN_INDEX] * K
                   + toy_tokenizer(post))
        resp = toy_tokenizer(f"class {y[v]}")
        lab = [IGNORE_INDEX] * len(seq_ids) + resp
        seq_ids = (seq_ids + resp)[:max_len]
        ids[b, :len(seq_ids)] = seq_ids
        labels[b, :len(lab[:max_len])] = lab[:max_len]

    model = LLaGAModel(num_graph_tokens=K, template=args.template,
                       use_hop=h, sample_size=s)
    idj, labj = jnp.asarray(ids), jnp.asarray(labels)
    params = model.init(jax.random.PRNGKey(args.seed), graph_inputs,
                        idj, labj)
    state = TrainState.create(params=params, tx=optax.adam(args.lr))

    @jax.jit
    def step(state, graph_inputs, ids, labels):
        loss, grads = jax.value_and_grad(
            lambda p: model.apply(p, graph_inputs, ids, labels))(
            state.params)
        return state.apply_gradients(grads), loss

    for epoch in range(args.n_epoch):
        state, loss = step(state, graph_inputs, idj, labj)
        if epoch % 10 == 0 or epoch == args.n_epoch - 1:
            print(f"epoch {epoch:3d} [{args.template}] "
                  f"instruction CE {float(loss):.4f}")
    return float(loss)


if __name__ == "__main__":
    parser = base_parser(n_epoch=40, lr=0.003, batch_size=16)
    parser.add_argument("--template", choices=["nd", "ho"], default="nd")
    main(parser.parse_args())
