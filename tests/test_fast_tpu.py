"""End-to-end drill: one GCN trained through the public API
(`GCNModel`, `TrainState`, `semi_supervised_loss`) reduces the loss."""

import numpy as np
import jax
import jax.numpy as jnp


def test_gcn_step_learns():
    import optax
    from gammagl_tpu.models import GCNModel
    from gammagl_tpu.train import TrainState, semi_supervised_loss

    rng = np.random.default_rng(0)
    n, f, c = 200, 16, 3
    y = rng.integers(0, c, n)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[np.arange(n), y] += 2.0
    same = (rng.integers(0, n, 800) // c) * c + y[rng.integers(0, n, 800)]
    ei = np.stack([same % n, rng.integers(0, n, 800)])
    xj, eij = jnp.asarray(x), jnp.asarray(ei)
    yj = jnp.asarray(y)
    mask = jnp.asarray(np.ones(n, bool))

    model = GCNModel(hidden_dim=8, num_class=c, drop_rate=0.0)
    params = model.init(jax.random.PRNGKey(0), xj, eij)
    state = TrainState.create(params=params, tx=optax.adam(0.05))

    @jax.jit
    def steps(state, x, ei, y, mask):
        def body(state, _):
            loss, grads = jax.value_and_grad(
                lambda p: semi_supervised_loss(model.apply(p, x, ei), y,
                                               mask))(state.params)
            return state.apply_gradients(grads), loss
        return jax.lax.scan(body, state, None, length=40)

    state, losses = steps(state, xj, eij, yj, mask)
    losses = np.asarray(losses)
    assert losses[-1] < losses[0] * 0.8, losses
