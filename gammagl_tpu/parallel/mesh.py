"""Device mesh helpers.

Net-new vs the reference (SURVEY.md section 2.10: GammaGL has no distributed
execution). Scale-out here is a named `jax.sharding.Mesh` +
`shard_map`/`pjit`, with XLA collectives between the devices.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["make_mesh", "replicate", "shard", "PartitionSpec",
           "NamedSharding"]


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("dp",),
              devices=None) -> Mesh:
    """Build a mesh over available devices.

    Default: one 'dp' axis over all devices. Pass shape=(dp, tp) and
    axis_names=("dp","tp") for 2-D meshes.
    """
    devices = devices if devices is not None else jax.devices()
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, axis_names)


def replicate(mesh: Mesh, tree):
    """device_put a pytree fully replicated over the mesh."""
    sharding = NamedSharding(mesh, PartitionSpec())
    return jax.device_put(tree, sharding)


def shard(mesh: Mesh, tree, spec: PartitionSpec):
    """device_put a pytree with one PartitionSpec for all leaves."""
    sharding = NamedSharding(mesh, spec)
    return jax.device_put(tree, sharding)
