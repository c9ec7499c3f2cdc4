"""Serving tier: AOT InferenceSession + StableHLO export roundtrip."""

import numpy as np
import jax
import jax.numpy as jnp

from gammagl_tpu.data import Graph
from gammagl_tpu.models import GCNModel
from gammagl_tpu.serve import (InferenceSession, export_forward,
                               load_exported, save_exported)


def _setup(seed=0, n=50, e=200, f=8, c=3):
    rng = np.random.default_rng(seed)
    ei = jnp.asarray(np.stack([rng.integers(0, n, e),
                               rng.integers(0, n, e)]))
    x = jnp.asarray(rng.normal(size=(n, f)).astype(np.float32))
    model = GCNModel(hidden_dim=16, num_class=c)
    params = model.init(jax.random.PRNGKey(0), x, ei)
    return model, params, x, ei


def test_inference_session_matches_apply():
    model, params, x, ei = _setup()
    want = model.apply(params, x, ei)
    sess = InferenceSession(model.apply, params, (x, ei))
    got = sess(x, ei)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert sess.memory_analysis is not None


def test_export_roundtrip(tmp_path):
    model, params, x, ei = _setup(seed=1)
    want = np.asarray(model.apply(params, x, ei))
    exp = export_forward(model.apply, params, (x, ei))
    save_exported(exp, tmp_path / "gcn.stablehlo")
    back = load_exported(tmp_path / "gcn.stablehlo")
    got = np.asarray(back.call(x, ei))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_session_bf16_compute():
    model, params, x, ei = _setup(seed=2)
    sess = InferenceSession(model.apply, params, (x, ei),
                            compute_dtype=jnp.bfloat16)
    got = sess(x, ei)
    want = model.apply(params, x.astype(jnp.bfloat16), ei)
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_sharded_session_matches_apply():
    """Full-graph serving sharded over the 8-device mesh: node-sharded
    features, replicated edges, node-sharded logits."""
    from jax.sharding import PartitionSpec as P
    from gammagl_tpu.parallel import make_mesh
    from gammagl_tpu.serve import ShardedInferenceSession

    model, params, x, ei = _setup(seed=3, n=64, e=256)
    want = np.asarray(model.apply(params, x, ei))
    mesh = make_mesh(axis_names=("dp",))
    sess = ShardedInferenceSession(model.apply, params, (x, ei), mesh,
                                   in_specs=(P("dp"), P()),
                                   out_specs=P("dp"))
    got = np.asarray(sess(x, ei))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert sess.memory_analysis is not None


def test_sharded_session_export_roundtrip(tmp_path):
    from jax.sharding import PartitionSpec as P
    from gammagl_tpu.parallel import make_mesh
    from gammagl_tpu.serve import ShardedInferenceSession

    model, params, x, ei = _setup(seed=4, n=64, e=256)
    want = np.asarray(model.apply(params, x, ei))
    mesh = make_mesh(axis_names=("dp",))
    sess = ShardedInferenceSession(model.apply, params, (x, ei), mesh,
                                   in_specs=(P("dp"), P()),
                                   out_specs=P("dp"))
    exp = sess.export()
    save_exported(exp, tmp_path / "gcn_sharded.stablehlo")
    back = load_exported(tmp_path / "gcn_sharded.stablehlo")
    got = np.asarray(back.call(*sess.device_put(x, ei)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_micro_batcher_batches_and_splits():
    from gammagl_tpu.serve import MicroBatcher

    seen_batches = []

    def run(batch, n_valid):
        seen_batches.append((int(batch.shape[0]), n_valid))
        return batch * 2.0

    with MicroBatcher(run, buckets=(4, 16), linger_ms=30.0) as mb:
        items = [jnp.full((3,), float(i)) for i in range(10)]
        futs = [mb.submit(it) for it in items]
        outs = [f.result(timeout=30) for f in futs]
    for i, o in enumerate(outs):
        np.testing.assert_allclose(np.asarray(o), 2.0 * i)
    # every launched batch was padded to a declared bucket
    assert all(b in (4, 16) for b, _ in seen_batches)
    assert sum(n for _, n in seen_batches) == 10


def test_micro_batcher_propagates_errors():
    from gammagl_tpu.serve import MicroBatcher

    def run(batch, n_valid):
        raise RuntimeError("boom")

    with MicroBatcher(run, buckets=(2,), linger_ms=1.0) as mb:
        fut = mb.submit(jnp.zeros((2,)))
        try:
            fut.result(timeout=30)
            raised = False
        except RuntimeError:
            raised = True
    assert raised


def test_export_roundtrip_nested_outputs(tmp_path):
    """An artifact whose outputs are a nested dict/list/tuple keeps that
    structure through save and load."""
    model, params, x, ei = _setup(seed=2)

    def two_heads(p, x, ei):
        out = model.apply(p, x, ei)
        return {"logits": out, "rest": [out.sum(0), (out.max(),)]}

    exp = export_forward(two_heads, params, (x, ei))
    save_exported(exp, tmp_path / "two.stablehlo")
    back = load_exported(tmp_path / "two.stablehlo")
    got, want = back.call(x, ei), two_heads(params, x, ei)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
