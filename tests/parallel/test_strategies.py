"""pp/sp/ep parallel strategies vs sequential references (8-dev CPU mesh)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from gammagl_tpu.ops import spmm
from gammagl_tpu.parallel import (make_feature_sharded_spmm, pipeline_apply,
                                  relation_expert_spmm)


@pytest.fixture
def devs():
    d = jax.devices()
    if len(d) < 4:
        pytest.skip("needs >= 4 devices")
    return np.array(d[:4])


def test_feature_sharded_spmm(devs):
    mesh = Mesh(devs, ("sp",))
    rng = np.random.default_rng(0)
    n, e, f = 32, 100, 16
    ei = jnp.asarray(np.stack([rng.integers(0, n, e),
                               rng.integers(0, n, e)]))
    w = jnp.asarray(rng.random(e).astype(np.float32))
    x = jnp.asarray(rng.normal(size=(n, f)).astype(np.float32))
    out = make_feature_sharded_spmm(mesh, n)(ei, w, x)
    ref = spmm(ei, w, x, num_nodes=n)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_relation_expert_spmm(devs):
    mesh = Mesh(devs, ("ep",))
    rng = np.random.default_rng(1)
    n, e, f, o, R = 24, 90, 8, 6, 7   # R not divisible by ndev -> padding
    ei = jnp.asarray(np.stack([rng.integers(0, n, e),
                               rng.integers(0, n, e)]))
    et = jnp.asarray(rng.integers(0, R, e))
    x = jnp.asarray(rng.normal(size=(n, f)).astype(np.float32))
    W = jnp.asarray(rng.normal(size=(R, f, o)).astype(np.float32) * 0.1)
    out = relation_expert_spmm(mesh, ei, et, x, W, n)
    msg = jnp.einsum("ef,efo->eo", x[ei[0]], W[et])
    ref = jax.ops.segment_sum(msg, ei[1], num_segments=n)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def test_pipeline_apply_matches_sequential(devs):
    mesh = Mesh(devs, ("pp",))
    rng = np.random.default_rng(2)
    S, M, B, F = 4, 5, 8, 12
    params = jnp.asarray(rng.normal(size=(S, F, F)).astype(np.float32)
                         * 0.1)
    xm = jnp.asarray(rng.normal(size=(M, B, F)).astype(np.float32))

    def stage_fn(p, h):
        return jnp.tanh(h @ p)

    out = pipeline_apply(mesh, stage_fn, params, xm)
    ref = xm
    for s in range(S):
        ref = jnp.tanh(ref @ params[s])
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


# ---- gradient parity (round 4): sp/ep/pp are TRAINING tiers, not
# forward-only demos — each strategy's grads must match the sequential
# reference --------------------------------------------------------------

def test_feature_sharded_spmm_grad(devs):
    mesh = Mesh(devs, ("sp",))
    rng = np.random.default_rng(3)
    n, e, f = 32, 100, 16
    ei = jnp.asarray(np.stack([rng.integers(0, n, e),
                               rng.integers(0, n, e)]))
    w = jnp.asarray(rng.random(e).astype(np.float32))
    x = jnp.asarray(rng.normal(size=(n, f)).astype(np.float32))
    run = make_feature_sharded_spmm(mesh, n)
    coef = jnp.asarray(rng.normal(size=(n, f)).astype(np.float32))

    g_sp = jax.grad(lambda x: jnp.sum(run(ei, w, x) * coef))(x)
    g_ref = jax.grad(
        lambda x: jnp.sum(spmm(ei, w, x, num_nodes=n) * coef))(x)
    np.testing.assert_allclose(np.asarray(g_sp), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-5)


def test_relation_expert_spmm_grad(devs):
    from gammagl_tpu.parallel import (make_relation_expert_spmm,
                                      shard_expert_weights)
    mesh = Mesh(devs, ("ep",))
    rng = np.random.default_rng(4)
    n, e, f, o, R = 24, 90, 8, 6, 7
    ei = jnp.asarray(np.stack([rng.integers(0, n, e),
                               rng.integers(0, n, e)]))
    et = jnp.asarray(rng.integers(0, R, e))
    x = jnp.asarray(rng.normal(size=(n, f)).astype(np.float32))
    W = jnp.asarray(rng.normal(size=(R, f, o)).astype(np.float32) * 0.1)
    coef = jnp.asarray(rng.normal(size=(n, o)).astype(np.float32))

    run = make_relation_expert_spmm(mesh, n)
    ws = shard_expert_weights(mesh, W)
    gx_ep, gw_ep = jax.grad(
        lambda x, w: jnp.sum(run(ei, et, x, w) * coef),
        argnums=(0, 1))(x, ws)

    def ref_loss(x, W):
        msg = jnp.einsum("ef,efo->eo", x[ei[0]], W[et])
        return jnp.sum(
            jax.ops.segment_sum(msg, ei[1], num_segments=n) * coef)

    gx_ref, gw_ref = jax.grad(ref_loss, argnums=(0, 1))(x, W)
    np.testing.assert_allclose(np.asarray(gx_ep), np.asarray(gx_ref),
                               rtol=1e-4, atol=1e-5)
    ndev = 4
    per = -(-R // ndev)
    gw_ep_flat = np.asarray(gw_ep).reshape(per * ndev, f, o)[:R]
    np.testing.assert_allclose(gw_ep_flat, np.asarray(gw_ref),
                               rtol=1e-4, atol=1e-5)


def test_pipeline_grad(devs):
    from gammagl_tpu.parallel import (make_pipeline_apply,
                                      shard_pipeline_params)
    mesh = Mesh(devs, ("pp",))
    rng = np.random.default_rng(5)
    S, M, B, F = 4, 5, 8, 12
    params = jnp.asarray(rng.normal(size=(S, F, F)).astype(np.float32)
                         * 0.1)
    xm = jnp.asarray(rng.normal(size=(M, B, F)).astype(np.float32))
    coef = jnp.asarray(rng.normal(size=(M, B, F)).astype(np.float32))

    def stage_fn(p, h):
        return jnp.tanh(h @ p)

    run = make_pipeline_apply(mesh, stage_fn, M)
    ps = shard_pipeline_params(mesh, params)
    g_pp = jax.grad(lambda p: jnp.sum(run(p, xm) * coef))(ps)

    def ref_loss(params):
        h = xm
        for s in range(S):
            h = jnp.tanh(h @ params[s])
        return jnp.sum(h * coef)

    g_ref = jax.grad(ref_loss)(params)
    np.testing.assert_allclose(np.asarray(g_pp), np.asarray(g_ref),
                               rtol=1e-4, atol=1e-5)
