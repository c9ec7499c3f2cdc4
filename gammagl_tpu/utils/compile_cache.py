"""JAX's persistent compilation cache at a fixed place.

JAX reads `JAX_COMPILATION_CACHE_DIR` itself; when it is set, nothing here
changes it. Otherwise the cache goes to `<checkout>/.jax_cache`: a fixed
path, because the path is part of the cache's key and a moving directory
never hits.
"""

import os
import os.path as osp

import jax

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = osp.join(
    osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache():
    """Returns the cache directory in use: `JAX_COMPILATION_CACHE_DIR` if
    set (left to JAX), else `DEFAULT_CACHE_DIR`, which this sets."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
