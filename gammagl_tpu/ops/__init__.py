"""Message-passing kernel layer.

Collapses the reference's per-backend mpops matrix + C++/CUDA extensions
(gammagl/mpops/__init__.py:10-29 backend switch; torch_ext/paddle_ext native
modules) into one JAX surface of XLA gathers, scatters and segment
reductions.
"""

from gammagl_tpu.ops.segment import (
    segment_sum,
    segment_mean,
    segment_max,
    segment_min,
    segment_count,
    gather_rows,
    unsorted_segment_sum,
    unsorted_segment_mean,
    unsorted_segment_max,
    unsorted_segment_min,
)
from gammagl_tpu.ops.softmax import segment_softmax
from gammagl_tpu.ops.spmm import spmm, bspmm, gspmm
from gammagl_tpu.ops.sddmm import sddmm, sddmm_dot
from gammagl_tpu.ops.sparse import (
    ind2ptr,
    ptr2ind,
    ind2ptr_np,
    ptr2ind_np,
    unique_np,
)

__all__ = [
    "segment_sum",
    "segment_mean",
    "segment_max",
    "segment_min",
    "segment_count",
    "gather_rows",
    "unsorted_segment_sum",
    "unsorted_segment_mean",
    "unsorted_segment_max",
    "unsorted_segment_min",
    "segment_softmax",
    "spmm",
    "bspmm",
    "gspmm",
    "sddmm",
    "sddmm_dot",
    "ind2ptr",
    "ptr2ind",
    "ind2ptr_np",
    "ptr2ind_np",
    "unique_np",
]
