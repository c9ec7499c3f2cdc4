"""chip_smoke.py and bench.py at a tiny size on the CPU: every phase's
control flow and parity checks, and the refusal to run without a GPU."""

import numpy as np
import pytest

import bench
import chip_smoke

TINY = dict(n=300, e=2400, f=16, classes=5)
TINY_OPS = dict(n=300, e=2400, f_wide=32, f_narrow=8, hgt_src=200,
                hgt_dst=100, hgt_e=1500, hgt_dim=8)


@pytest.fixture(scope="module")
def task():
    return chip_smoke.node_task(0, **TINY)


def test_refuses_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_without_gpu():
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)


def test_node_task_shapes(task):
    x, ei, y, train = task
    n = TINY["n"]
    assert x.shape == (n, TINY["f"]) and y.shape == (n,)
    assert ei.shape == (2, TINY["e"] + n)          # self-loops appended
    assert ei.min() >= 0 and ei.max() < n
    assert 0.3 < train.mean() < 0.8


def test_gcn_norm_csr_matches_gcnconv_weights(task):
    import jax
    import jax.numpy as jnp
    from gammagl_tpu.layers.conv import GCNConv

    x, ei, _, _ = task
    conv = GCNConv(4)
    p = conv.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ei))
    got = conv.apply(p, jnp.asarray(x), jnp.asarray(ei))
    h = x.astype(np.float64) @ np.asarray(p["params"]["Dense_0"]["kernel"])
    want = chip_smoke.gcn_norm_csr(ei, x.shape[0]) @ h
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5)


def test_phase_gcn_train_and_serve(task):
    logs = []
    run = chip_smoke.phase_gcn_train(task, log=logs.append)
    assert run["losses"][-1] < run["losses"][0]
    assert any("scipy float64" in m for m in logs)
    chip_smoke.phase_serve(task, run, requests=2, log=logs.append)
    assert any("parity exported program" in m for m in logs)
    # flatbuffers is installed here, so the round trip runs
    assert any("parity reloaded artifact" in m for m in logs)


@pytest.mark.parametrize("case", range(8))
def test_bench_op_case(case):
    cases = bench._cases(TINY_OPS)
    assert len(cases) == 8
    res = bench.run_case(*cases[case], iters=2)
    assert res["err_out"] <= res["tol"]
    assert res["err_grad"] <= res["grad_tol"]
    assert res["fwd_ms"] > 0 and res["fwd_bwd_ms"] > 0


def test_run_case_rejects_wrong_op():
    import jax.numpy as jnp
    x = (jnp.arange(12.0).reshape(4, 3),)
    with pytest.raises(AssertionError):
        bench.run_case("wrong", 4, lambda ei, a: a * 1.1,
                       lambda ei, a: a, x, jnp.zeros((2, 1), jnp.int32),
                       "sum_order", iters=1)


@pytest.mark.parametrize("recipe", ["gcn", "gat"])
def test_partitioned_matches_one_part(task, recipe):
    import jax
    many = chip_smoke.partitioned_run(task, recipe, jax.devices()[:4],
                                      steps=2)
    one = chip_smoke.partitioned_run(task, recipe, jax.devices()[:1],
                                     steps=2)
    assert abs(many["loss0"] - one["loss0"]) <= 1e-4 * abs(one["loss0"])
    for g, r in zip(jax.tree_util.tree_leaves(many["grads"]),
                    jax.tree_util.tree_leaves(one["grads"])):
        assert bench.rel_err(g, r) <= 1e-3
    np.testing.assert_allclose(many["losses"], one["losses"], rtol=1e-3)
