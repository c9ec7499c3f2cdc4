"""SpMM / BSpMM: fused message + aggregate over COO edges.

Counterpart of the reference's gspmm/bspmm C++ autograd kernels
(gammagl/mpops/torch.py:302,354; gammagl/mpops/torch_ext/src/gspmm.cpp:26-80).
The reference hand-writes forward scatter + backward gather; here the forward
is gather -> scale -> segment reduce, expressed so XLA fuses the gather and
multiply into the scatter, and autodiff produces the transposed-graph SpMM
backward for free. This is the COO entry point used by `MessagePassing`.

bf16/f16 features are gathered in their own dtype; the scaling and the
reduction, forward and backward, run in f32, and the result is cast back.
"""

from typing import Optional

import jax.numpy as jnp

from gammagl_tpu.ops.segment import (accum_dtype, gather_rows, segment_max,
                                     segment_mean, segment_min, segment_sum)

__all__ = ["spmm", "bspmm", "gspmm"]

_REDUCE = {"sum": segment_sum, "mean": segment_mean, "max": segment_max,
           "min": segment_min}


def _scaled_reduce(x, src, dst, w, w_shape, num_nodes, reduce):
    if reduce not in _REDUCE:
        raise ValueError(f"unknown reduce {reduce!r}")
    out_dtype = x.dtype if w is None else jnp.result_type(x, w)
    # The gather clamps OOB pad src; the scatter drops OOB dst, so pads
    # are exact no-ops.
    msg = gather_rows(x, src).astype(accum_dtype(out_dtype))
    if w is not None:
        msg = msg * w.astype(msg.dtype).reshape(w_shape)
    return _REDUCE[reduce](msg, dst, num_nodes).astype(out_dtype)


def spmm(edge_index, edge_weight, x, num_nodes: Optional[int] = None,
         reduce: str = "sum"):
    """out[d] = reduce_{(s,d) in E} w_{sd} * x[s].

    Parameters
    ----------
    edge_index : (2, E) int array, row 0 = src, row 1 = dst
        (reference convention gammagl/layers/conv/message_passing.py:55-61).
    edge_weight : (E,) or None
    x : (N, F) node features
    num_nodes : static int; defaults to x.shape[0]
    reduce : 'sum' | 'mean' | 'max' | 'min'
    """
    if num_nodes is None:
        num_nodes = x.shape[0]
    return _scaled_reduce(x, edge_index[0], edge_index[1], edge_weight,
                          (-1,) + (1,) * (x.ndim - 1), num_nodes, reduce)


# Reference name (gammagl/mpops/torch.py:302).
def gspmm(edge_index, edge_weight, x, reduce: str = "sum",
          num_nodes: Optional[int] = None):
    return spmm(edge_index, edge_weight, x, num_nodes=num_nodes,
                reduce=reduce)


def bspmm(edge_index, edge_weight, x, num_nodes: Optional[int] = None,
          reduce: str = "sum"):
    """Batched (multi-head) SpMM for attention convs.

    Reference: gammagl/mpops/torch.py:354 (BSpMMSum); x is (N, H, F),
    edge_weight is (E, H) per-head attention coefficients.
    """
    if num_nodes is None:
        num_nodes = x.shape[0]
    w_shape = None if edge_weight is None else edge_weight.shape + (1,)
    return _scaled_reduce(x, edge_index[0], edge_index[1], edge_weight,
                          w_shape, num_nodes, reduce)
