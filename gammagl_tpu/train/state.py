"""Train state + full checkpointing.

The reference checkpoints weights only (`net.save_weights(...npz_dict)`,
examples/gcn/gcn_trainer.py:110-113 -- no optimizer state, no step).
This supersedes it (SURVEY.md section 5): params + optimizer state + step
serialized together, so training resumes exactly.
"""

import dataclasses
import functools
from typing import Any

import numpy as np
import jax
import optax

__all__ = ["TrainState", "save_checkpoint", "load_checkpoint",
           "save_checkpoint_sharded", "load_checkpoint_sharded"]


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["step", "params", "opt_state"],
                   meta_fields=["tx"])
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: int
    params: Any
    opt_state: Any
    tx: optax.GradientTransformation

    @classmethod
    def create(cls, params, tx):
        return cls(step=0, params=params, opt_state=tx.init(params), tx=tx)

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    def apply_gradients(self, grads):
        updates, opt_state = self.tx.update(grads, self.opt_state,
                                            self.params)
        params = optax.apply_updates(self.params, updates)
        return self.replace(step=self.step + 1, params=params,
                            opt_state=opt_state)


def _payload(state):
    return {"step": state.step, "params": state.params,
            "opt_state": state.opt_state}


def save_checkpoint(path, state: TrainState):
    """Write step + params + optimizer state to one `.npz` file, one entry
    per leaf, keyed by its tree path."""
    leaves = jax.tree_util.tree_flatten_with_path(_payload(state))[0]
    arrays = {jax.tree_util.keystr(k): np.asarray(jax.device_get(v))
              for k, v in leaves}
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_checkpoint(path, state: TrainState) -> TrainState:
    """Restore into an existing state (template provides structure/tx)."""
    template = _payload(state)
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    with np.load(path) as data:
        missing = [jax.tree_util.keystr(k) for k, _ in paths
                   if jax.tree_util.keystr(k) not in data]
        if missing:
            raise ValueError(f"checkpoint {path} lacks {missing[:5]}")
        leaves = [data[jax.tree_util.keystr(k)] for k, _ in paths]
    restored = jax.tree_util.tree_unflatten(treedef, leaves)
    return state.replace(step=int(restored["step"]),
                         params=restored["params"],
                         opt_state=restored["opt_state"])


def save_checkpoint_sharded(path, tree, step=None):
    """Orbax checkpoint for MESH-SHARDED pytrees (the papers100M tier:
    node-sharded features/params/optimizer state that no single host can
    device_get). Every process calls this with the same global arrays;
    each host writes only its addressable shards. Preemption-safe resume
    for multi-chip full-graph training (SURVEY.md §5 — the reference has
    weight files only)."""
    import os.path as osp
    import orbax.checkpoint as ocp
    path = osp.abspath(str(path))  # orbax requires absolute paths
    with ocp.PyTreeCheckpointer() as ckptr:
        payload = dict(tree)
        # numpy scalar: identical on every host (orbax treats host-local
        # numpy as replicated and lets the primary write it) -- a
        # jax.Array here would be committed to one local device per
        # process and collide across hosts. Always written so restore
        # can always request it.
        payload["_step"] = np.asarray(0 if step is None else step,
                                      np.int64)
        ckptr.save(path, payload, force=True)


def load_checkpoint_sharded(path, template):
    """Restore a sharded pytree saved by `save_checkpoint_sharded`.
    `template` supplies the target shapes/dtypes/SHARDINGS (pass the
    freshly-initialized global arrays); returns (tree, step)."""
    import os.path as osp
    import orbax.checkpoint as ocp
    path = osp.abspath(str(path))
    with ocp.PyTreeCheckpointer() as ckptr:
        tmpl = dict(template)
        tmpl["_step"] = np.asarray(0, np.int64)  # matches the saved leaf
        abstract = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(
                x.shape, x.dtype, sharding=getattr(x, "sharding", None)),
            tmpl)
        restored = ckptr.restore(
            path, args=ocp.args.PyTreeRestore(
                item=abstract,
                restore_args=ocp.checkpoint_utils.construct_restore_args(
                    abstract)))
    step = int(restored.pop("_step"))
    del tmpl["_step"]
    # re-place every leaf exactly like the template (scalars otherwise
    # come back committed to one device and clash with mesh-wide args
    # inside jit)
    restored = jax.tree_util.tree_map(
        lambda r, t: jax.device_put(r, t.sharding)
        if hasattr(t, "sharding") else r, restored, tmpl)
    return restored, step
