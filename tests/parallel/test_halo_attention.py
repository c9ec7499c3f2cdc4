"""Partitioned GAT attention (halo tier) vs a dense single-device reference.

Reference semantics: gammagl/layers/conv/gat_conv.py — per-head score
LeakyReLU(a_src.h_src + a_dst.h_dst), softmax over each destination's
incoming edges, weighted sum of source features. Runs on the 8-virtual-CPU
mesh from conftest.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gammagl_tpu.parallel import (build_halo_partition_attn,
                                  make_partitioned_gat_layer)


def _graph(n=96, e=800, heads=2, fh=8, seed=0):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    # ensure every node has at least one incoming edge (self loop)
    ei = np.concatenate([ei, np.stack([np.arange(n), np.arange(n)])], 1)
    x = rng.normal(size=(n, heads * fh)).astype(np.float32) * 0.5
    a_src = rng.normal(size=(heads, fh)).astype(np.float32) * 0.5
    a_dst = rng.normal(size=(heads, fh)).astype(np.float32) * 0.5
    return ei, x, a_src, a_dst


def _dense_gat(ei, x, a_src, a_dst, n, heads, slope=0.2):
    """Plain jnp reference (single device, original edge order)."""
    fh = x.shape[1] // heads
    h3 = x.reshape(n, heads, fh).astype(jnp.float32)
    src, dst = ei[0], ei[1]
    as_n = jnp.einsum("nhf,hf->nh", h3, a_src.astype(jnp.float32))
    ad_n = jnp.einsum("nhf,hf->nh", h3, a_dst.astype(jnp.float32))
    e = jax.nn.leaky_relu(as_n[src] + ad_n[dst], slope)     # (E, H)
    m = jax.ops.segment_max(e, dst, n)
    ex = jnp.exp(e - m[dst])
    s = jax.ops.segment_sum(ex, dst, n)
    alpha = ex / s[dst]
    out = jax.ops.segment_sum(alpha[:, :, None] * h3[src], dst, n)
    return out.reshape(n, heads * fh)


def _mesh(ndev):
    return Mesh(np.asarray(jax.devices()[:ndev]), ("dp",))


def _shard(x, mesh, total):
    n = x.shape[0]
    return jax.device_put(jnp.asarray(np.pad(x, ((0, total - n), (0, 0)))),
                          NamedSharding(mesh, P("dp")))


@pytest.mark.parametrize("heads", [1, 3])
def test_partitioned_gat_matches_dense(heads):
    n, ndev, fh = 96, 4, 8
    ei, x, a_src, a_dst = _graph(n, heads=heads, fh=fh, seed=1)
    mesh = _mesh(ndev)
    part = build_halo_partition_attn(ei, n, ndev)
    total = part.num_parts * part.rows_per
    layer = make_partitioned_gat_layer(mesh, part, heads)
    out = jax.jit(layer)(_shard(x, mesh, total),
                         jnp.asarray(a_src), jnp.asarray(a_dst))
    ref = _dense_gat(jnp.asarray(ei), jnp.asarray(x), jnp.asarray(a_src),
                     jnp.asarray(a_dst), n, heads)
    got = np.asarray(out).reshape(total, -1)[:n]
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_partitioned_gat_grads_match_dense():
    n, ndev, heads, fh = 80, 8, 2, 8
    ei, x, a_src, a_dst = _graph(n, e=600, heads=heads, fh=fh, seed=3)
    mesh = _mesh(ndev)
    part = build_halo_partition_attn(ei, n, ndev)
    total = part.num_parts * part.rows_per
    layer = make_partitioned_gat_layer(mesh, part, heads)
    xs = _shard(x, mesh, total)

    def loss(xv, asv, adv):
        return jnp.sum(layer(xv, asv, adv) ** 2)

    gx, gas, gad = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        xs, jnp.asarray(a_src), jnp.asarray(a_dst))

    def ref_loss(xv, asv, adv):
        return jnp.sum(_dense_gat(jnp.asarray(ei), xv, asv, adv, n,
                                  heads) ** 2)

    rx, ras, rad = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(a_src), jnp.asarray(a_dst))
    np.testing.assert_allclose(np.asarray(gx).reshape(total, -1)[:n],
                               np.asarray(rx), rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(np.asarray(gas), np.asarray(ras),
                               rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(np.asarray(gad), np.asarray(rad),
                               rtol=3e-3, atol=3e-3)


def test_partitioned_gat_full_graph_recipe():
    # end-to-end: L-layer GAT trains on an SBM through the full-graph tier
    from gammagl_tpu.parallel import make_partitioned_gat_train, shard_nodes
    from tests.parallel.test_full_graph import _sbm
    ei, x, y = _sbm(seed=17)
    n, f = x.shape
    mesh = _mesh(4)
    part = build_halo_partition_attn(ei, n, 4)
    params, opt_state, step, eval_logits = make_partitioned_gat_train(
        mesh, part, feat_dim=f, hidden_dim=8, num_classes=2, heads=2,
        num_layers=2, compute_dtype=jnp.float32, learning_rate=5e-2)
    mask = np.ones(n, np.float32)
    xs = shard_nodes(x, mesh, part)
    ys = shard_nodes(y, mesh, part)
    ms = shard_nodes(mask, mesh, part)
    losses = []
    for _ in range(40):
        params, opt_state, loss = step(params, opt_state, xs, ys, ms)
        losses.append(float(loss))
    assert losses[-1] < 0.4 * losses[0], losses[::10]
    logits = np.asarray(eval_logits(params, xs))[:n]
    acc = (logits.argmax(1) == y).mean()
    assert acc > 0.9, acc


def test_partitioned_gat_isolated_destination():
    # nodes without incoming edges must output exactly zero (softmax over
    # an empty set), matching segment-softmax semantics, not NaN
    n, ndev, heads, fh = 64, 4, 2, 4
    rng = np.random.default_rng(5)
    # only edges into the first half of nodes
    ei = np.stack([rng.integers(0, n, 300), rng.integers(0, n // 2, 300)])
    x = rng.normal(size=(n, heads * fh)).astype(np.float32)
    a_src = rng.normal(size=(heads, fh)).astype(np.float32)
    a_dst = rng.normal(size=(heads, fh)).astype(np.float32)
    mesh = _mesh(ndev)
    part = build_halo_partition_attn(ei, n, ndev)
    total = part.num_parts * part.rows_per
    layer = make_partitioned_gat_layer(mesh, part, heads)
    out = np.asarray(jax.jit(layer)(_shard(x, mesh, total),
                                    jnp.asarray(a_src),
                                    jnp.asarray(a_dst))).reshape(total, -1)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[n // 2:n], 0.0, atol=1e-6)
    ref = _dense_gat(jnp.asarray(ei), jnp.asarray(x), jnp.asarray(a_src),
                     jnp.asarray(a_dst), n, heads)
    np.testing.assert_allclose(out[:n // 2], np.asarray(ref)[:n // 2],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_partitioned_gat_device_counts(ndev):
    """Output and gradients match the dense layer on 2, 4 and 8 devices;
    every device's edge list is dst-sorted with pads at the end."""
    n, heads, fh = 72, 2, 4
    ei, x, a_src, a_dst = _graph(n, e=500, heads=heads, fh=fh, seed=ndev)
    mesh = _mesh(ndev)
    part = build_halo_partition_attn(ei, n, ndev)
    assert part.src_local.shape == part.dst_local.shape
    for d in part.dst_local:
        assert (np.diff(d) >= 0).all() and d.max() <= part.rows_per
    total = part.num_parts * part.rows_per
    layer = make_partitioned_gat_layer(mesh, part, heads)
    xs = _shard(x, mesh, total)
    out = np.asarray(jax.jit(layer)(xs, jnp.asarray(a_src),
                                    jnp.asarray(a_dst))).reshape(total, -1)
    ref = _dense_gat(jnp.asarray(ei), jnp.asarray(x), jnp.asarray(a_src),
                     jnp.asarray(a_dst), n, heads)
    np.testing.assert_allclose(out[:n], np.asarray(ref), rtol=2e-4,
                               atol=2e-4)
    ga = jax.jit(jax.grad(lambda v: jnp.sum(layer(
        xs, v, jnp.asarray(a_dst)) ** 2)))(jnp.asarray(a_src))
    ra = jax.grad(lambda v: jnp.sum(_dense_gat(
        jnp.asarray(ei), jnp.asarray(x), v, jnp.asarray(a_dst), n,
        heads) ** 2))(jnp.asarray(a_src))
    np.testing.assert_allclose(np.asarray(ga), np.asarray(ra), rtol=3e-3,
                               atol=3e-3)
