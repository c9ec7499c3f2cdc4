"""TrainState checkpoint roundtrip (supersedes reference weights-only
save, SURVEY.md section 5)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax

from gammagl_tpu.train import (TrainState, save_checkpoint, load_checkpoint,
                               accuracy, macro_f1, semi_supervised_loss)


def test_checkpoint_roundtrip(tmp_path):
    params = {"w": jnp.ones((3, 2)), "b": jnp.zeros(2)}
    tx = optax.adam(1e-2)
    state = TrainState.create(params=params, tx=tx)
    grads = {"w": jnp.ones((3, 2)) * 0.1, "b": jnp.ones(2)}
    state = state.apply_gradients(grads)
    state = state.apply_gradients(grads)
    assert state.step == 2

    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, state)
    fresh = TrainState.create(params=params, tx=tx)
    restored = load_checkpoint(path, fresh)
    assert restored.step == 2
    np.testing.assert_allclose(np.asarray(restored.params["w"]),
                               np.asarray(state.params["w"]))
    # optimizer state restored too -> next update identical
    s1 = state.apply_gradients(grads)
    s2 = restored.apply_gradients(grads)
    np.testing.assert_allclose(np.asarray(s1.params["b"]),
                               np.asarray(s2.params["b"]), rtol=1e-6)


def test_metrics():
    logits = jnp.asarray([[2.0, 0.0], [0.0, 2.0], [2.0, 0.0]])
    labels = jnp.asarray([0, 1, 1])
    assert abs(float(accuracy(logits, labels)) - 2 / 3) < 1e-6
    mask = jnp.asarray([True, True, False])
    assert float(accuracy(logits, labels, mask)) == 1.0
    loss = semi_supervised_loss(logits, labels, mask)
    assert float(loss) > 0
    f1 = macro_f1(logits, labels)
    assert 0 < float(f1) <= 1
