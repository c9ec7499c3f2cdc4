"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The reference's test axis is the multi-backend matrix (SURVEY.md section 4);
ours is multi-device: every test runs on 8 virtual CPU devices so sharding /
collective paths are exercised without a multi-GPU host. The flag must be
set before JAX creates its CPU backend.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
