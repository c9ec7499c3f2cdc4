"""gammagl_tpu: a graph learning framework on JAX.

A from-scratch JAX / XLA re-design of the capability surface of
GammaGL (BUPT-GAMMA/GammaGL): message-passing kernels, graph data structures,
a conv/model zoo, dataset/loader infrastructure, and -- beyond the reference --
multi-chip distributed training via `jax.sharding` meshes with halo exchange.

Layer map (cf. reference SURVEY.md section 1):
  ops/        -- segment reductions, SpMM, SDDMM, edge softmax (XLA)
  data/       -- Graph / HeteroGraph pytrees, batching, Dataset lifecycle
  datasets/   -- dataset classes (Planetoid, Amazon, TUDataset, ...)
  layers/     -- MessagePassing + conv zoo, pooling, attention
  models/     -- assembled GNN models
  loader/     -- DataLoader, neighbor/saint/random-walk loaders
  sampler/    -- host-side neighbor sampling (C++ core + numpy fallback)
  transforms/ -- graph transforms
  utils/      -- graph utilities (degree, self-loops, coalesce, ...)
  parallel/   -- device meshes, graph partitioning, halo exchange
"""

__version__ = "0.1.0"

from gammagl_tpu import ops  # noqa: F401
from gammagl_tpu import utils  # noqa: F401
from gammagl_tpu import data  # noqa: F401
from gammagl_tpu import serve  # noqa: F401
