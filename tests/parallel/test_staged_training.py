"""Layer-staged partitioned training (make_partitioned_gcn_train_staged)
must reproduce the monolithic train step's learning curve exactly: same
init, same math, only the jit boundaries move. Also covers the
chunked-CE custom VJP against the direct f32 loss."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from gammagl_tpu.parallel import (build_halo_partition, make_mesh,
                                  make_partitioned_gcn_train,
                                  make_partitioned_gcn_train_staged,
                                  shard_nodes)
from gammagl_tpu.parallel.full_graph import _masked_ce_chunked
from gammagl_tpu.utils import calc_gcn_norm_np


def _setup(seed=0, n=400, e=2600, f=32, c=5):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    ei = np.concatenate([ei, np.tile(np.arange(n), (2, 1))], 1)
    w = calc_gcn_norm_np(ei, n)
    mesh = make_mesh(axis_names=("dp",))
    num_parts = int(np.prod(mesh.devices.shape))
    part = build_halo_partition(ei, n, num_parts, w)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = rng.integers(0, c, n)
    train = np.ones(n, bool)
    xs = shard_nodes(x, mesh, part, dtype=jnp.bfloat16)
    ys = shard_nodes(y, mesh, part)
    ms = shard_nodes(train.astype(np.float32), mesh, part)
    return mesh, part, xs, ys, ms, f, c


def test_staged_matches_monolithic():
    mesh, part, xs, ys, ms, f, c = _setup()
    curves = {}
    for name, maker in [
            ("mono", lambda: make_partitioned_gcn_train(
                mesh, part, f, 16, c, num_layers=3,
                compute_dtype=jnp.bfloat16, remat=True, seed=1)),
            ("staged", lambda: make_partitioned_gcn_train_staged(
                mesh, part, f, 16, c, num_layers=3,
                compute_dtype=jnp.bfloat16, seed=1))]:
        params, opt_state, step, _ = maker()
        ls = []
        for _ in range(6):
            params, opt_state, loss = step(params, opt_state, xs, ys, ms)
            ls.append(float(loss))
        curves[name] = ls
    np.testing.assert_allclose(curves["staged"], curves["mono"],
                               rtol=1e-3, atol=1e-3)
    assert curves["staged"][-1] < curves["staged"][0]


def test_staged_eval_logits():
    mesh, part, xs, ys, ms, f, c = _setup(seed=2)
    params, opt_state, step, ev = make_partitioned_gcn_train_staged(
        mesh, part, f, 16, c, num_layers=2,
        compute_dtype=jnp.bfloat16, seed=3)
    for _ in range(4):
        params, opt_state, loss = step(params, opt_state, xs, ys, ms)
    logits = ev(params, xs)
    assert logits.shape[-1] == c
    assert bool(jnp.all(jnp.isfinite(logits.astype(jnp.float32))))


@pytest.mark.parametrize("n,CH", [(1000, 256), (700, 1024), (64, 64)])
def test_masked_ce_chunked_exact(n, CH):
    rng = np.random.default_rng(0)
    C = 17
    lg = jnp.asarray(rng.normal(size=(n, C)), jnp.bfloat16)
    y = jnp.asarray(rng.integers(0, C, n))
    m = jnp.asarray((rng.random(n) > 0.3).astype(np.float32))

    def ref(l):
        ls = optax.softmax_cross_entropy_with_integer_labels(
            l.astype(jnp.float32), y)
        return (ls * m).sum() / m.sum()

    got = _masked_ce_chunked(lg, y, m, CH)
    np.testing.assert_allclose(float(got), float(ref(lg)), rtol=1e-6)
    g1 = jax.grad(lambda l: _masked_ce_chunked(l, y, m, CH))(lg)
    g2 = jax.grad(ref)(lg)
    np.testing.assert_array_equal(np.asarray(g1, np.float32),
                                  np.asarray(g2, np.float32))


@pytest.mark.parametrize("n,CH", [(1000, 256), (64, 64)])
def test_masked_ce_chunked_mask_grad(n, CH):
    # the custom VJP must carry the REAL mask cotangent (per-row loss
    # enters the weighted mean; the normalizer subtracts the mean loss),
    # not silently return zeros — callers may weight rows with floats
    rng = np.random.default_rng(1)
    C = 11
    lg = jnp.asarray(rng.normal(size=(n, C)), jnp.float32)
    y = jnp.asarray(rng.integers(0, C, n))
    m = jnp.asarray(rng.random(n).astype(np.float32)) + 0.1

    def ref(mm):
        ls = optax.softmax_cross_entropy_with_integer_labels(lg, y)
        return (ls * mm).sum() / jnp.maximum(mm.sum(), 1.0)

    gm1 = jax.grad(lambda mm: _masked_ce_chunked(lg, y, mm, CH))(m)
    gm2 = jax.grad(ref)(m)
    np.testing.assert_allclose(np.asarray(gm1), np.asarray(gm2),
                               rtol=1e-5, atol=1e-7)
    # sub-unit mask sum: the max(Σm, 1) clamp kills the normalizer term
    msmall = m * 1e-3
    gm3 = jax.grad(lambda mm: _masked_ce_chunked(lg, y, mm, CH))(msmall)
    gm4 = jax.grad(ref)(msmall)
    np.testing.assert_allclose(np.asarray(gm3), np.asarray(gm4),
                               rtol=1e-5, atol=1e-7)
