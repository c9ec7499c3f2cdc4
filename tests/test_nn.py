"""gammagl_tpu.nn: flax.linen's interface and parameter-tree names."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gammagl_tpu import nn

X = jnp.ones((2, 4))


def shapes(tree):
    return jax.tree_util.tree_map(jnp.shape, tree)


class Compact(nn.Module):
    @nn.compact
    def __call__(self, x):
        return nn.Sequential([nn.Dense(3), nn.relu, nn.Dense(2)])(x)


class Setup(nn.Module):
    def setup(self):
        self.blocks = [{"a": nn.Dense(2), "b": nn.LayerNorm()}
                       for _ in range(2)]
        self.proj = nn.Sequential([nn.Dense(3), nn.relu, nn.Dense(2)])

    def __call__(self, x):
        return self.blocks[1]["a"](self.proj(x))


class Holder(nn.Module):
    sub: nn.Module

    @nn.compact
    def __call__(self, x):
        return self.sub(x)


def test_compact_autonames_children():
    p = Compact().init(jax.random.PRNGKey(0), X)
    assert shapes(p) == {"params": {
        "Dense_0": {"kernel": (4, 3), "bias": (3,)},
        "Dense_1": {"kernel": (3, 2), "bias": (2,)}}}


def test_setup_names_by_attribute():
    p = Setup().init(jax.random.PRNGKey(0), X)
    assert set(p["params"]) == {"blocks_1_a", "proj"}
    assert set(p["params"]["proj"]) == {"layers_0", "layers_2"}


def test_field_module_is_adopted_under_field_name():
    p = Holder(nn.Dense(5)).init(jax.random.PRNGKey(0), X)
    assert shapes(p) == {"params": {"sub": {"kernel": (4, 5),
                                            "bias": (5,)}}}


def test_apply_reuses_params_and_calls_share_them():
    class Twice(nn.Module):
        @nn.compact
        def __call__(self, x):
            d = nn.Dense(4)
            return d(d(x))

    m = Twice()
    p = m.init(jax.random.PRNGKey(0), X)
    assert list(p["params"]) == ["Dense_0"]
    k = p["params"]["Dense_0"]["kernel"]
    b = p["params"]["Dense_0"]["bias"]
    np.testing.assert_allclose(m.apply(p, X), (X @ k + b) @ k + b,
                               rtol=1e-6)


def test_init_is_seeded_and_params_are_distinct():
    a = Compact().init(jax.random.PRNGKey(0), X)
    b = Compact().init(jax.random.PRNGKey(0), X)
    c = Compact().init(jax.random.PRNGKey(1), X)
    ka, kb, kc = (t["params"]["Dense_0"]["kernel"] for t in (a, b, c))
    np.testing.assert_array_equal(ka, kb)
    assert not np.allclose(ka, kc)
    assert not np.allclose(a["params"]["Dense_1"]["kernel"][:3, :2],
                           ka[:3, :2])


def test_dropout_needs_rng_and_draws_fresh_masks():
    class Drop(nn.Module):
        @nn.compact
        def __call__(self, x, train):
            d = nn.Dropout(0.5, deterministic=not train)
            return d(x), d(x)

    x = jnp.ones((64,))
    a, b = Drop().apply({}, x, train=False)
    np.testing.assert_array_equal(a, x)
    a, b = Drop().apply({}, x, train=True,
                        rngs={"dropout": jax.random.PRNGKey(1)})
    assert set(np.unique(np.asarray(a))) <= {0.0, 2.0}
    assert not np.array_equal(a, b)
    with pytest.raises(ValueError):
        Drop().apply({}, x, train=True)


def test_mutable_collection_roundtrip():
    class Counter(nn.Module):
        @nn.compact
        def __call__(self):
            c = self.variable("stats", "n", lambda: jnp.zeros(()))
            if not self.is_initializing():
                c.value = c.value + 1
            return c.value

    m = Counter()
    v = m.init(jax.random.PRNGKey(0))
    assert float(v["stats"]["n"]) == 0.0
    out, upd = m.apply(v, mutable=["stats"])
    assert float(upd["stats"]["n"]) == 1.0
    assert float(v["stats"]["n"]) == 0.0      # the input is not mutated
    with pytest.raises(ValueError):
        m.apply(v)                            # stats not mutable


def test_method_and_capture_intermediates():
    class Two(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(3, name="enc")(x)

        def double(self, x):
            return 2 * self(x)

    m = Two()
    p = m.init(jax.random.PRNGKey(0), X)
    np.testing.assert_allclose(m.apply(p, X, method="double"),
                               2 * m.apply(p, X), rtol=1e-6)
    np.testing.assert_allclose(m.apply(p, X, method=Two.double),
                               2 * m.apply(p, X), rtol=1e-6)
    _, inter = m.apply(p, X, capture_intermediates=True)
    assert inter["intermediates"]["enc"]["__call__"][0].shape == (2, 3)


def test_layers_match_their_formulas():
    k = jax.random.PRNGKey(0)
    x = jax.random.normal(k, (3, 5))
    ln = nn.LayerNorm()
    p = ln.init(k, x)
    want = (x - x.mean(-1, keepdims=True)) / jnp.sqrt(
        x.var(-1, keepdims=True) + 1e-6)
    np.testing.assert_allclose(ln.apply(p, x), want, rtol=1e-5, atol=1e-5)

    emb = nn.Embed(10, 4)
    p = emb.init(k, jnp.array([1, 2]))
    table = p["params"]["embedding"]
    np.testing.assert_array_equal(emb.apply(p, jnp.array([3, 3])),
                                  table[jnp.array([3, 3])])

    conv = nn.Conv(6, kernel_size=(3,))
    p = conv.init(k, jnp.ones((2, 8, 5)))
    assert shapes(p)["params"]["kernel"] == (3, 5, 6)
    assert conv.apply(p, jnp.ones((2, 8, 5))).shape == (2, 8, 6)
    pooled = nn.max_pool(jnp.arange(8.0).reshape(1, 8, 1), (2,), (2,))
    np.testing.assert_array_equal(pooled.ravel(), [1, 3, 5, 7])


def test_self_attention_causal_mask():
    m = nn.SelfAttention(num_heads=2, qkv_features=8, deterministic=True)
    x = jax.random.normal(jax.random.PRNGKey(0), (1, 5, 6))
    p = m.init(jax.random.PRNGKey(1), x)
    assert shapes(p)["params"]["query"]["kernel"] == (6, 2, 4)
    assert shapes(p)["params"]["out"]["kernel"] == (2, 4, 6)
    mask = nn.make_causal_mask(jnp.zeros((1, 5)))
    y = m.apply(p, x, mask=mask)
    # position 0 attends to itself only: changing later tokens keeps it
    y2 = m.apply(p, x.at[:, 1:].set(0.0), mask=mask)
    np.testing.assert_allclose(y[:, 0], y2[:, 0], rtol=1e-5, atol=1e-6)


def test_unbound_module_refuses_params():
    with pytest.raises(ValueError):
        nn.Dense(3)(X)
