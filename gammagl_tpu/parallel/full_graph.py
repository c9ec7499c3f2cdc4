"""Memory-budgeted full-graph training at papers100M scale.

The reference has no multi-device training at all (SURVEY.md §2.10); its
largest-graph recipe is host-side neighbor sampling. This module is the
full-graph tier: nodes stay **sharded over the mesh for the
whole run** — features, activations, labels, logits all live as
`P('dp')`-sharded arrays; only the per-layer halo exchange
(`make_halo_spmm`) moves boundary rows between devices. Everything else (dense
layers, loss, optimizer) is plain jnp under `jit`, so the GSPMD
partitioner keeps it local to each shard.

Two recipes, matching the BASELINE papers100M configs ("GCN/SIGN on
ogbn-papers100M edge-partitioned"):

* `make_partitioned_gcn_train` — an L-layer GCN whose train step never
  materializes an unsharded activation. Memory knobs:
    - `compute_dtype=bfloat16`: activations and the halo traffic run
      bf16 (params and the optimizer stay f32),
    - `remat=True`: each layer is `jax.checkpoint`-ed, so backward
      holds one layer's activations at a time (the halo exchange is
      recomputed, trading one extra all_to_all for O(L) memory).
* `sign_precompute` — K halo-SpMM sweeps produce [X, AX, ..., A^K X]
  as node-sharded (optionally bf16) operands; training then needs NO
  graph at all (an MLP over the concatenated operands, embarrassingly
  data-parallel). This is the practical single-pass recipe for graphs
  whose edge list dwarfs HBM.

`estimate_hbm_gb` sizes a config before launch (the reference has no
analog; at 111M nodes the difference between f32 and bf16 activations
is the difference between fitting and OOM).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from gammagl_tpu.parallel.halo import (HaloPartition, build_halo_partition,
                                       make_halo_spmm)
from gammagl_tpu.parallel.hier_halo import (HierHaloPartition,
                                            make_hier_halo_spmm)

__all__ = ["pad_nodes", "unpad_nodes", "shard_nodes", "sign_precompute",
           "make_partitioned_gcn_train",
           "make_partitioned_gcn_train_staged",
           "make_partitioned_gat_train", "estimate_hbm_gb"]


def _make_spmm(mesh, part, axis):
    """Halo SpMM by partition type: flat (`HaloPartition`) or two-level
    (`HierHaloPartition`). All recipes below work unchanged on either."""
    if isinstance(part, HierHaloPartition):
        axes = tuple(axis) if isinstance(axis, (tuple, list)) \
            else ("slice", "dp")
        return make_hier_halo_spmm(mesh, part, axes)
    return make_halo_spmm(mesh, part, axis)


def pad_nodes(arr, part, fill=0):
    """Pad a per-node array (N, ...) to the partition's (P*rows_per, ...).

    Balanced partitions (default) carry a node relabeling; per-node data
    is reordered with ``arr[node_perm]`` here so callers feed natural
    order everywhere. Un-permute per-node RESULTS with
    ``out[:N][part.node_inv]``.
    """
    arr = np.asarray(arr)
    perm = getattr(part, "node_perm", None)
    if perm is not None:
        arr = arr[perm]
    total = part.num_parts * part.rows_per
    pad = [(0, total - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=fill)


def unpad_nodes(out, part):
    """Inverse of `pad_nodes` for per-node RESULTS: strip padding and undo
    the balanced relabeling, returning natural-order (N, ...) numpy."""
    out = np.asarray(out)[:part.num_nodes]
    inv = getattr(part, "node_inv", None)
    return out if inv is None else out[inv]


def shard_nodes(arr, mesh, part, axis="dp", fill=0, dtype=None):
    """Pad + device_put a per-node array sharded along the node dim.

    For a `HierHaloPartition` pass ``axis=("slice", "dp")``."""
    out = pad_nodes(arr, part, fill)
    if dtype is not None:
        out = out.astype(dtype)
    if isinstance(part, HierHaloPartition) \
            and not isinstance(axis, (tuple, list)):
        axis = ("slice", "dp")
    return jax.device_put(jnp.asarray(out), NamedSharding(mesh, P(axis)))


def sign_precompute(mesh, part, x_sharded, num_hops,
                    store_dtype=jnp.bfloat16, axis="dp"):
    """K sweeps of the halo SpMM: returns [X, AX, ..., A^K X], each
    node-sharded and cast to `store_dtype` (reference SIGN transform:
    gammagl/transforms/sign.py:7, which materializes dense scipy powers —
    impossible at papers100M; here each sweep is one all_to_all + local
    segment-sum, and the graph can be dropped afterwards)."""
    spmm = jax.jit(_make_spmm(mesh, part, axis))
    ops = [x_sharded.astype(store_dtype)]
    h = x_sharded
    for _ in range(num_hops):
        h = spmm(h)
        ops.append(h.astype(store_dtype))
    return ops


def _glorot(rng, fan_in, fan_out):
    s = np.sqrt(6.0 / (fan_in + fan_out))
    return jnp.asarray(rng.uniform(-s, s, (fan_in, fan_out)), jnp.float32)


@partial(jax.custom_vjp, nondiff_argnums=(3,))
def _masked_ce_chunked(logits, y, m, CH=131_072):
    """Mean masked softmax cross-entropy with the f32 math confined to
    CH-row chunks (fori_loop + dynamic slices -- no scan residual
    stacking). Full f32 logits at papers100M shard scale cost 2.33 GB
    for a 3.55M-node shard; the naive lax.scan chunking is WORSE
    (autodiff stacks per-chunk softmax residuals back to full size).
    The custom backward recomputes softmax per chunk from the saved
    compute-dtype logits: dl = (softmax - onehot) * m * g / msum."""
    n, C = logits.shape
    nch = -(-n // CH)

    def body(i, tot):
        lg = jax.lax.dynamic_slice(
            logits, (i * CH, 0), (CH, C)).astype(jnp.float32)
        yy = jax.lax.dynamic_slice(y, (i * CH,), (CH,))
        mm = jax.lax.dynamic_slice(m, (i * CH,), (CH,))
        ls = optax.softmax_cross_entropy_with_integer_labels(lg, yy)
        return tot + (ls * mm).sum()

    pad = nch * CH - n
    if pad:
        logits = jnp.pad(logits, ((0, pad), (0, 0)))
        y = jnp.pad(y, (0, pad))
        m = jnp.pad(m, (0, pad))
    tot = jax.lax.fori_loop(0, nch, body, jnp.zeros((), jnp.float32))
    return tot / jnp.maximum(m.sum(), 1.0)


def _masked_ce_fwd(logits, y, m, CH):
    out = _masked_ce_chunked(logits, y, m, CH)
    return out, (logits, y, m, out)


def _masked_ce_bwd(CH, res, g):
    logits, y, m, out = res
    n, C = logits.shape
    nch = -(-n // CH)
    pad = nch * CH - n
    lg_p = jnp.pad(logits, ((0, pad), (0, 0))) if pad else logits
    y_p = jnp.pad(y, (0, pad)) if pad else y
    m_p = jnp.pad(m, (0, pad)) if pad else m
    msum = m.sum()
    scale = g / jnp.maximum(msum, 1.0)
    # dL/dm_i = (ls_i - L) / Σm: the per-row loss enters the weighted
    # mean directly; -L/Σm comes from the normalizer (zero when the
    # max(Σm, 1) clamp is active, i.e. Σm < 1 — then only ls_i remains).
    sub = jnp.where(msum >= 1.0, out, 0.0)

    def body(i, carry):
        dl, dm = carry
        lg = jax.lax.dynamic_slice(
            lg_p, (i * CH, 0), (CH, C)).astype(jnp.float32)
        yy = jax.lax.dynamic_slice(y_p, (i * CH,), (CH,))
        mm = jax.lax.dynamic_slice(m_p, (i * CH,), (CH,))
        p = jax.nn.softmax(lg, axis=-1)
        oh = jax.nn.one_hot(yy, C, dtype=jnp.float32)
        d = (p - oh) * (mm * scale)[:, None]
        ls = optax.softmax_cross_entropy_with_integer_labels(lg, yy)
        dmi = (ls - sub) * scale
        return (jax.lax.dynamic_update_slice(
                    dl, d.astype(dl.dtype), (i * CH, 0)),
                jax.lax.dynamic_update_slice(
                    dm, dmi.astype(dm.dtype), (i * CH,)))

    dl, dm = jax.lax.fori_loop(
        0, nch, body, (jnp.zeros((nch * CH, C), logits.dtype),
                       jnp.zeros((nch * CH,), m.dtype)))
    return dl[:n], None, dm[:n]


_masked_ce_chunked.defvjp(_masked_ce_fwd, _masked_ce_bwd)


def make_partitioned_gcn_train(mesh, part, feat_dim,
                               hidden_dim, num_classes, num_layers=2,
                               compute_dtype=jnp.bfloat16, remat=True,
                               learning_rate=1e-2, weight_decay=0.0,
                               seed=0, axis="dp"):
    """Build (params, opt_state, train_step, eval_logits) for an L-layer
    GCN over a halo partition.

    The train step's signature is
        train_step(params, opt_state, x, y, mask) -> (params, opt_state, loss)
    where x is (P*rows_per, F) sharded P(axis), y/mask are (P*rows_per,)
    sharded P(axis) (mask is 0 on pads and non-train rows). Params are
    replicated f32; activations run in `compute_dtype`.
    """
    spmm = _make_spmm(mesh, part, axis)
    rng = np.random.default_rng(seed)
    dims = [feat_dim] + [hidden_dim] * (num_layers - 1) + [num_classes]
    params = {f"w{i}": _glorot(rng, dims[i], dims[i + 1])
              for i in range(num_layers)}
    params.update({f"b{i}": jnp.zeros(dims[i + 1], jnp.float32)
                   for i in range(num_layers)})
    params = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P())), params)

    opt = optax.adamw(learning_rate, weight_decay=weight_decay)
    # replicate over the mesh (committed): keeps every leaf's placement
    # explicit so checkpoint restore reproduces it exactly
    opt_state = jax.device_put(opt.init(params),
                               NamedSharding(mesh, P()))

    def layer(p, i, h):
        # halo traffic rides in compute_dtype; the f32 edge weights make
        # the segment accumulation f32 — cast back down for the matmul
        h = spmm(h).astype(compute_dtype)
        w = p[f"w{i}"].astype(compute_dtype)
        b = p[f"b{i}"].astype(compute_dtype)
        return h @ w + b

    if remat:
        layer = jax.checkpoint(layer, static_argnums=(1,))

    single_dev = int(np.prod(mesh.devices.shape)) == 1

    def forward(p, x):
        h = x.astype(compute_dtype)
        for i in range(num_layers):
            h = layer(p, i, h)
            if i < num_layers - 1:
                h = jax.nn.relu(h)
        if single_dev:
            return h       # stay compute_dtype; the loss casts per chunk
        return h.astype(jnp.float32)  # logits f32 for the loss

    def loss_fn(p, x, y, mask):
        logits = forward(p, x)
        m = mask.astype(jnp.float32)
        if single_dev and logits.shape[0] > 262_144:
            return _masked_ce_chunked(logits, y, m)
        ls = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), y)
        return (ls * m).sum() / jnp.maximum(m.sum(), 1.0)

    @jax.jit
    def train_step(p, opt_state, x, y, mask):
        loss, grads = jax.value_and_grad(loss_fn)(p, x, y, mask)
        updates, opt_state = opt.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    # eval always hands back f32 logits regardless of device count: the
    # single-device forward stays compute_dtype internally (the chunked
    # loss casts per chunk), but external consumers of eval_logits get
    # the same dtype contract as the multi-device path.
    eval_logits = jax.jit(lambda p, x: forward(p, x).astype(jnp.float32))

    return params, opt_state, train_step, eval_logits


def make_partitioned_gcn_train_staged(mesh, part, feat_dim, hidden_dim,
                                      num_classes, num_layers=3,
                                      compute_dtype=jnp.bfloat16,
                                      learning_rate=1e-2,
                                      weight_decay=0.0, seed=0,
                                      axis="dp"):
    """Layer-STAGED variant of `make_partitioned_gcn_train` for shards
    beyond single-jit memory.

    The monolithic train step holds every layer's activations, their
    cotangents, and the SpMM working set in ONE XLA buffer-assignment
    problem, so its peak grows with the sum of those. Here
    forward and backward run as SEPARATE jits per layer with the layer
    inputs as the only cross-jit residuals, so the compiler's peak is
    one layer's working set:

        fwd_i : h_i -> h_{i+1}                       (spmm + matmul)
        head  : logits, y, m -> loss, dlogits        (chunked f32 CE)
        bwd_i : h_i, h_{i+1}, dh_{i+1} -> dh_i, dW_i, db_i
                (recomputes a_i = spmm(h_i); dh_i is the SpMM's VJP)

    The host loop costs ~2L jit dispatches per epoch. Same
    signature/return convention as the monolithic builder.
    """
    spmm = _make_spmm(mesh, part, axis)
    rng = np.random.default_rng(seed)
    dims = [feat_dim] + [hidden_dim] * (num_layers - 1) + [num_classes]
    params = {f"w{i}": _glorot(rng, dims[i], dims[i + 1])
              for i in range(num_layers)}
    params.update({f"b{i}": jnp.zeros(dims[i + 1], jnp.float32)
                   for i in range(num_layers)})
    params = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P())), params)
    opt = optax.adamw(learning_rate, weight_decay=weight_decay)
    opt_state = jax.device_put(opt.init(params),
                               NamedSharding(mesh, P()))
    cd = compute_dtype

    @partial(jax.jit, static_argnums=(3,))
    def fwd_layer(w, b, h, relu):
        a = spmm(h.astype(cd)).astype(cd)
        out = a @ w.astype(cd) + b.astype(cd)
        return jax.nn.relu(out) if relu else out

    single_dev = int(np.prod(mesh.devices.shape)) == 1

    # donations keep the live set down: logits die into the head (the
    # last layer's backward never reads h_out -- relu=False), and each
    # backward consumes the activation/cotangent it retires
    @partial(jax.jit, donate_argnums=(0,))
    def head(logits, y, mask):
        m = mask.astype(jnp.float32)
        if single_dev and logits.shape[0] > 262_144:
            fn = lambda lg: _masked_ce_chunked(lg, y, m)  # noqa: E731
        else:
            def fn(lg):
                ls = optax.softmax_cross_entropy_with_integer_labels(
                    lg.astype(jnp.float32), y)
                return (ls * m).sum() / jnp.maximum(m.sum(), 1.0)
        loss, dl = jax.value_and_grad(fn)(logits)
        return loss, dl

    @partial(jax.jit, static_argnums=(4,), donate_argnums=(2, 3))
    def bwd_matmul(w, h_in, h_out, dh_out, relu):
        """Recompute a_i = spmm(h_i); emit (dw, db, da) -- the dh_in
        transpose SpMM runs in its own jit (see bwd_spmm_t)."""
        dh = dh_out
        if relu:
            dh = dh * (h_out > 0).astype(dh.dtype)
        a = spmm(h_in.astype(cd)).astype(cd)
        # f32 param grads from bf16 operands (accumulation in f32)
        dw = jax.lax.dot_general(
            a, dh, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        db = jnp.sum(dh.astype(jnp.float32), axis=0)
        da = (dh @ w.astype(cd).T).astype(cd)
        return da, dw, db

    @partial(jax.jit, donate_argnums=(0,))
    def bwd_spmm_t(da):
        # transpose via vjp (forward recompute on a ZERO operand keeps the
        # extra pass trivial for the linear spmm)
        out, vjp_fn = jax.vjp(spmm, jnp.zeros_like(da))
        return vjp_fn(da.astype(out.dtype))[0].astype(cd)

    @jax.jit
    def apply_grads(p, opt_state, grads):
        updates, opt_state = opt.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    def train_step(p, opt_state, x, y, mask):
        hs = [x]
        for i in range(num_layers):
            hs.append(fwd_layer(p[f"w{i}"], p[f"b{i}"], hs[-1],
                                i < num_layers - 1))
        loss, dh = head(hs[-1], y, mask)
        # the head donated the logits; the last layer's backward ignores
        # h_out entirely (relu=False), so hand it an empty pytree
        hs[num_layers] = None
        grads = {}
        for i in reversed(range(num_layers)):
            da, dw, db = bwd_matmul(p[f"w{i}"], hs[i], hs[i + 1], dh,
                                    i < num_layers - 1)
            grads[f"w{i}"] = dw
            grads[f"b{i}"] = db
            hs[i + 1] = None    # free the activation as soon as possible
            dh = bwd_spmm_t(da) if i else None
        p, opt_state = apply_grads(p, opt_state, grads)
        return p, opt_state, loss

    def eval_logits(p, x):
        h = x
        for i in range(num_layers):
            h = fwd_layer(p[f"w{i}"], p[f"b{i}"], h,
                          i < num_layers - 1)
        # same f32 contract as the monolithic builder's eval path
        return h.astype(jnp.float32)

    return params, opt_state, train_step, eval_logits


def make_partitioned_gat_train(mesh, part, feat_dim, hidden_dim,
                               num_classes, heads=4, num_layers=2,
                               compute_dtype=jnp.bfloat16, remat=True,
                               learning_rate=1e-2, weight_decay=0.0,
                               negative_slope=0.2, seed=0, axis="dp"):
    """Build (params, opt_state, train_step, eval_logits) for an L-layer
    GAT over an `AttnHaloPartition` (reference GATModel:
    gammagl/models/gat.py:10 — concat heads on hidden layers, average on
    the output layer; the reference trains it single-device only).

    `hidden_dim` is PER HEAD; hidden activations are (rows,
    heads*hidden_dim). Same step signature as the GCN recipe. Each layer
    does one projection matmul (local under GSPMD), one halo all_to_all,
    a local edge softmax and an alpha-weighted segment sum; gradients
    flow through all of it.
    """
    from gammagl_tpu.parallel.halo_attention import (
        AttnHaloPartition, make_partitioned_gat_layer)
    assert isinstance(part, AttnHaloPartition), type(part)
    attn = make_partitioned_gat_layer(mesh, part, heads, axis=axis,
                                      negative_slope=negative_slope)
    rng = np.random.default_rng(seed)
    dims_in = [feat_dim] + [heads * hidden_dim] * (num_layers - 1)
    dims_out = [hidden_dim] * (num_layers - 1) + [num_classes]
    params = {}
    for i in range(num_layers):
        params[f"w{i}"] = _glorot(rng, dims_in[i], heads * dims_out[i])
        params[f"as{i}"] = _glorot(rng, heads, dims_out[i])
        params[f"ad{i}"] = _glorot(rng, heads, dims_out[i])
        params[f"b{i}"] = jnp.zeros(
            dims_out[i] * (heads if i < num_layers - 1 else 1), jnp.float32)
    params = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P())), params)

    opt = optax.adamw(learning_rate, weight_decay=weight_decay)
    opt_state = jax.device_put(opt.init(params), NamedSharding(mesh, P()))

    def layer(p, i, h):
        w = p[f"w{i}"].astype(compute_dtype)
        h = attn(h @ w, p[f"as{i}"], p[f"ad{i}"]).astype(compute_dtype)
        if i < num_layers - 1:
            return jax.nn.elu(h + p[f"b{i}"].astype(compute_dtype))
        # output layer: average the heads (reference concat=False tail)
        h = h.reshape(h.shape[0], heads, -1).mean(axis=1)
        return h + p[f"b{i}"].astype(compute_dtype)

    if remat:
        layer = jax.checkpoint(layer, static_argnums=(1,))

    def forward(p, x):
        h = x.astype(compute_dtype)
        for i in range(num_layers):
            h = layer(p, i, h)
        return h.astype(jnp.float32)

    def loss_fn(p, x, y, mask):
        logits = forward(p, x)
        ls = optax.softmax_cross_entropy_with_integer_labels(logits, y)
        m = mask.astype(jnp.float32)
        return (ls * m).sum() / jnp.maximum(m.sum(), 1.0)

    @jax.jit
    def train_step(p, opt_state, x, y, mask):
        loss, grads = jax.value_and_grad(loss_fn)(p, x, y, mask)
        updates, opt_state = opt.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    eval_logits = jax.jit(forward)
    return params, opt_state, train_step, eval_logits


def estimate_hbm_gb(num_nodes, feat_dim, hidden_dim, num_layers,
                    num_parts, avg_degree, compute_dtype=jnp.bfloat16,
                    remat=True):
    """Rough per-chip HBM for `make_partitioned_gcn_train` (features +
    activations + halo buffers + edge shard), in GB. Params/optimizer are
    negligible for GCN-sized models. Use to pick `num_parts` before
    launching."""
    rows = -(-num_nodes // num_parts)
    bytes_c = jnp.dtype(compute_dtype).itemsize
    feats = rows * feat_dim * bytes_c
    # live activations: remat keeps ~2 layers' worth, else all L
    live = 2 if remat else num_layers + 1
    acts = live * rows * hidden_dim * bytes_c
    # halo table: worst case every peer needs the full boundary ~ rows
    halo = rows * max(feat_dim, hidden_dim) * bytes_c
    edges = (num_nodes * avg_degree // num_parts) * (2 * 4 + 4)
    return (feats + acts + halo + edges) / 1e9
