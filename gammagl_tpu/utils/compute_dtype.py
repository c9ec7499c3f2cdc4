"""Global compute-dtype context (the bf16 recipe, one switch).

The reference's numerics are whatever the active TLX backend defaults to;
the split used here is **params f32, compute bf16** (bf16 features halve
the bytes every gather and scatter moves). Each conv/model takes a local
`dtype=` knob; this module adds a process-global default so a whole model
can flip with one line:

    from gammagl_tpu.utils import set_compute_dtype
    set_compute_dtype(jnp.bfloat16)   # or: with compute_dtype(jnp.bfloat16):
    model = GCNModel(...)             # every conv resolves dtype=None -> bf16

The global is read at TRACE time: set it before `jit`/`init` of the step
function. Changing it afterwards does not invalidate already-compiled
functions (XLA caches by traced graph, which baked the old dtype in).
"""

import contextlib

__all__ = ["set_compute_dtype", "get_compute_dtype", "compute_dtype",
           "resolve_dtype"]

_COMPUTE_DTYPE = None


def set_compute_dtype(dtype):
    """Set the process-global default compute dtype (None = full f32)."""
    global _COMPUTE_DTYPE
    _COMPUTE_DTYPE = dtype


def get_compute_dtype():
    return _COMPUTE_DTYPE


@contextlib.contextmanager
def compute_dtype(dtype):
    """Scoped default: `with compute_dtype(jnp.bfloat16): ...`"""
    global _COMPUTE_DTYPE
    prev = _COMPUTE_DTYPE
    _COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        _COMPUTE_DTYPE = prev


def resolve_dtype(local=None):
    """A layer's effective compute dtype: its own knob, else the global."""
    return local if local is not None else _COMPUTE_DTYPE
