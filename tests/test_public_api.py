"""Import contract: every name in each package __all__ must be importable.

Reference: tests/test_public_api.py:1-45.
"""

import importlib

import pytest

PACKAGES = [
    "gammagl_tpu",
    "gammagl_tpu.ops",
    "gammagl_tpu.nn",
    "gammagl_tpu.data",
    "gammagl_tpu.datasets",
    "gammagl_tpu.layers.conv",
    "gammagl_tpu.layers.pool",
    "gammagl_tpu.models",
    "gammagl_tpu.loader",
    "gammagl_tpu.sampler",
    "gammagl_tpu.transforms",
    "gammagl_tpu.utils",
    "gammagl_tpu.parallel",
    "gammagl_tpu.io",
]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_all_exports_importable(pkg):
    module = importlib.import_module(pkg)
    for name in getattr(module, "__all__", []):
        assert hasattr(module, name), f"{pkg}.{name} missing"
        assert getattr(module, name) is not None
