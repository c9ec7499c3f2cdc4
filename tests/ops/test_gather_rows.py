"""gather_rows: the edge gather whose gradient accumulates in f32."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gammagl_tpu.ops import bspmm, gather_rows, sddmm_dot, spmm

# bf16 keeps 8 mantissa bits: a bf16 running sum of ones stops at 256
HITS = 4096


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gather_rows_matches_take_and_clamps(dtype):
    x = jnp.arange(12, dtype=dtype).reshape(4, 3)
    idx = jnp.array([0, 3, 4, 9, 1], jnp.int32)  # 4 and 9 are out of range
    got = gather_rows(x, idx)
    want = np.asarray(x, np.float32)[np.minimum(np.asarray(idx), 3)]
    assert got.dtype == dtype
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gather_rows_grad_is_exact_sum(dtype):
    x = jnp.zeros((2, 3), dtype)
    idx = jnp.zeros(HITS, jnp.int32)
    g = jax.grad(lambda x: gather_rows(x, idx).astype(jnp.float32).sum())(x)
    assert g.dtype == dtype
    np.testing.assert_array_equal(np.asarray(g, np.float32)[0], HITS)
    np.testing.assert_array_equal(np.asarray(g, np.float32)[1], 0)


def test_gather_rows_forward_mode():
    x = jnp.arange(6, dtype=jnp.bfloat16).reshape(3, 2)
    idx = jnp.array([2, 0, 2], jnp.int32)
    out, tan = jax.jvp(lambda x: gather_rows(x, idx), (x,),
                       (jnp.ones_like(x),))
    assert tan.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(out, np.float32),
                                  np.asarray(x, np.float32)[[2, 0, 2]])
    np.testing.assert_array_equal(np.asarray(tan, np.float32), 1.0)


def _hub_edges(n=8):
    # every edge leaves node 0, so node 0's gradient sums HITS terms
    return jnp.stack([jnp.zeros(HITS, jnp.int32),
                      jnp.arange(HITS, dtype=jnp.int32) % n])


@pytest.mark.parametrize("op", ["spmm", "bspmm", "sddmm"])
def test_bf16_op_grad_of_hub_node_is_exact(op):
    n = 8
    ei = _hub_edges(n)
    if op == "spmm":
        fn = lambda x: spmm(ei, None, x, num_nodes=n)
        x = jnp.ones((n, 4), jnp.bfloat16)
    elif op == "bspmm":
        fn = lambda x: bspmm(ei, jnp.ones((HITS, 2), jnp.bfloat16), x,
                             num_nodes=n)
        x = jnp.ones((n, 2, 4), jnp.bfloat16)
    else:
        fn = lambda x: sddmm_dot(ei, x, jnp.ones((n, 4), jnp.bfloat16))
        x = jnp.ones((n, 4), jnp.bfloat16)
    g = jax.grad(lambda x: fn(x).astype(jnp.float32).sum())(x)
    np.testing.assert_array_equal(np.asarray(g, np.float32)[0], HITS)
