"""enable_compile_cache: JAX_COMPILATION_CACHE_DIR wins when set; else
<checkout>/.jax_cache. The config update is recorded, not applied, so the
suite's own compiles stay uncached."""

import os.path as osp

from gammagl_tpu.utils import compile_cache


def _record(monkeypatch):
    calls = []
    monkeypatch.setattr(compile_cache.jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    return calls


def test_env_var_set_configures_nothing(monkeypatch, tmp_path):
    calls = _record(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_env_var_unset_uses_checkout_cache(monkeypatch):
    calls = _record(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    root = osp.dirname(osp.dirname(osp.dirname(
        osp.abspath(compile_cache.__file__))))
    assert path == osp.join(root, ".jax_cache")
    assert osp.isfile(osp.join(root, "pyproject.toml"))
    assert calls == [("jax_compilation_cache_dir", path)]
