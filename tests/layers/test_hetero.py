"""Heterogeneous convs and models on a tiny typed graph."""

import numpy as np
import jax
import jax.numpy as jnp

from gammagl_tpu.layers.conv import (RGCNConv, HeteroConv, HANConv, HGTConv,
                                     SimpleHGNConv, GCNConv, SAGEConv)
from gammagl_tpu.models import (RGCNModel, HANModel, HGTModel,
                                SimpleHGNModel)


def _typed_graph():
    # 2 node types: paper(4), author(3); 2 edge types
    x_dict = {
        "paper": jnp.asarray(np.arange(12, dtype=np.float32).reshape(4, 3)),
        "author": jnp.asarray(np.ones((3, 5), np.float32)),
    }
    ei_dict = {
        ("author", "writes", "paper"): jnp.asarray(
            np.array([[0, 1, 2, 0], [0, 1, 2, 3]])),
        ("paper", "cites", "paper"): jnp.asarray(
            np.array([[0, 1, 2], [1, 2, 3]])),
    }
    metadata = (["paper", "author"], list(ei_dict.keys()))
    return x_dict, ei_dict, metadata


def test_rgcn_conv():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(5, 4)),
                    jnp.float32)
    ei = jnp.asarray(np.array([[0, 1, 2, 3], [1, 2, 3, 4]]))
    et = jnp.asarray(np.array([0, 1, 0, 1]))
    for kwargs in ({}, {"num_bases": 2}, {"num_blocks": 2}):
        conv = RGCNConv(in_channels=4, out_channels=6, num_relations=2,
                        **kwargs)
        params = conv.init(jax.random.PRNGKey(0), x, ei, et)
        out = conv.apply(params, x, ei, et)
        assert out.shape == (5, 6)
        assert np.isfinite(np.asarray(out)).all()


def test_rgcn_relation_separation():
    """Edges of relation 0 must only use weight[0]."""
    x = jnp.eye(3)
    ei = jnp.asarray(np.array([[0, 1], [2, 2]]))
    et = jnp.asarray(np.array([0, 1]))
    conv = RGCNConv(in_channels=3, out_channels=2, num_relations=2,
                    root_weight=False, add_bias=False)
    params = conv.init(jax.random.PRNGKey(0), x, ei, et)
    w = np.asarray(params["params"]["weight"])  # (2, 3, 2)
    out = np.asarray(conv.apply(params, x, ei, et))
    expect2 = w[0][0] + w[1][1]  # x0 under rel0 + x1 under rel1
    np.testing.assert_allclose(out[2], expect2, rtol=1e-5)


def test_hetero_conv_wrapper():
    x_dict, ei_dict, metadata = _typed_graph()
    conv = HeteroConv(convs={
        ("author", "writes", "paper"): SAGEConv(out_channels=8),
        ("paper", "cites", "paper"): GCNConv(out_channels=8),
    })
    params = conv.init(jax.random.PRNGKey(0), x_dict, ei_dict)
    out = conv.apply(params, x_dict, ei_dict)
    assert set(out.keys()) == {"paper"}
    assert out["paper"].shape == (4, 8)


def test_han_conv():
    x_dict, ei_dict, metadata = _typed_graph()
    conv = HANConv(out_channels=4, metadata=metadata, heads=2)
    params = conv.init(jax.random.PRNGKey(0), x_dict, ei_dict)
    out = conv.apply(params, x_dict, ei_dict)
    assert out["paper"].shape == (4, 8)  # heads * out


def test_hgt_conv():
    x_dict, ei_dict, metadata = _typed_graph()
    conv = HGTConv(out_channels=8, metadata=metadata, heads=2)
    params = conv.init(jax.random.PRNGKey(0), x_dict, ei_dict)
    out = conv.apply(params, x_dict, ei_dict)
    assert out["paper"].shape == (4, 8)
    assert np.isfinite(np.asarray(out["paper"])).all()


def test_simplehgn_conv():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(6, 4)),
                    jnp.float32)
    ei = jnp.asarray(np.array([[0, 1, 2, 3], [1, 2, 3, 0]]))
    et = jnp.asarray(np.array([0, 1, 0, 1]))
    conv = SimpleHGNConv(out_channels=5, num_etypes=2, heads=2)
    params = conv.init(jax.random.PRNGKey(0), x, ei, et)
    out, alpha = conv.apply(params, x, ei, et)
    assert out.shape == (6, 10)
    assert alpha.shape == (4, 2)


def test_hetero_models_learn():
    import optax
    x_dict, ei_dict, metadata = _typed_graph()
    y = jnp.asarray(np.array([0, 1, 0, 1]))

    for model in [
        HANModel(metadata=metadata, hidden_channels=4, num_class=2,
                 target_ntype="paper", heads=2, drop_rate=0.0),
        HGTModel(metadata=metadata, hidden_channels=8, num_class=2,
                 target_ntype="paper", heads=2),
    ]:
        params = model.init(jax.random.PRNGKey(0), x_dict, ei_dict)
        opt = optax.adam(1e-2)
        opt_state = opt.init(params)

        @jax.jit
        def step(params, opt_state):
            def loss_fn(p):
                logits = model.apply(p, x_dict, ei_dict)
                return optax.softmax_cross_entropy_with_integer_labels(
                    logits, y).mean()
            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = opt.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state, loss

        l0 = None
        for _ in range(15):
            params, opt_state, loss = step(params, opt_state)
            l0 = float(loss) if l0 is None else l0
        assert float(loss) < l0


def test_rgcn_simplehgn_models():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(6, 4)),
                    jnp.float32)
    ei = jnp.asarray(np.array([[0, 1, 2, 3], [1, 2, 3, 0]]))
    et = jnp.asarray(np.array([0, 1, 0, 1]))
    m = RGCNModel(in_channels=4, hidden_channels=8, num_class=3,
                  num_relations=2, num_bases=2)
    params = m.init(jax.random.PRNGKey(0), x, ei, et)
    assert m.apply(params, x, ei, et).shape == (6, 3)

    m2 = SimpleHGNModel(num_etypes=2, hidden_channels=4, num_class=3,
                        heads=2, drop_rate=0.0)
    params = m2.init(jax.random.PRNGKey(0), x, ei, et)
    assert m2.apply(params, x, ei, et).shape == (6, 3)
