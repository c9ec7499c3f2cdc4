"""Graph utilities (reference: gammagl/utils/__init__.py:25-58)."""

from gammagl_tpu.utils.degree import degree
from gammagl_tpu.utils.loop import (add_self_loops, remove_self_loops,
                                    contains_self_loops)
from gammagl_tpu.utils.norm import calc_gcn_norm, calc_gcn_norm_np
from gammagl_tpu.utils.mask import mask_to_index, index_to_mask
from gammagl_tpu.utils.coalesce import coalesce, sort_edge_index
from gammagl_tpu.utils.undirected import to_undirected, is_undirected
from gammagl_tpu.utils.subgraph import subgraph, k_hop_subgraph
from gammagl_tpu.utils.to_dense import to_dense_adj, to_dense_batch
from gammagl_tpu.utils.negative_sampling import (
    negative_sampling, batched_negative_sampling,
    structured_negative_sampling)
from gammagl_tpu.utils.misc import (homophily, get_laplacian,
                                    to_scipy_sparse_matrix,
                                    from_scipy_sparse_matrix,
                                    get_train_val_test_split)
from gammagl_tpu.utils.shortest_path import shortest_path
from gammagl_tpu.utils.smiles import from_smiles
from gammagl_tpu.utils import manifold_math
from gammagl_tpu.utils.unifews_log import (UniFewsLogger, ModelLogger, LayerNumLogger, F1Calculator, Stopwatch)
from gammagl_tpu.utils.profiling import median_time, trace, device_timer
from gammagl_tpu.utils.compile_cache import enable_compile_cache
from gammagl_tpu.utils import gfm_utils
from gammagl_tpu.utils.conversation import (Conversation, conv_templates,
                                            get_conv_template)
from gammagl_tpu.utils.paths_io import (find_all_simple_paths,
                                        read_embeddings, save_embeddings,
                                        Inspector)
from gammagl_tpu.utils.pruning import (threshold_prune, prune_params,
                                       rewind, sparsity,
                                       prune_edges_by_weight)
from gammagl_tpu.ops.softmax import segment_softmax
from gammagl_tpu.utils.compat_utils import (
    calc_A_norm_hat, edge_index_to_adj_matrix, get_few_shot_split,
    node_subgraph, set_device, shortest_path_distance,
    batched_shortest_path_distance)

from gammagl_tpu.utils.compute_dtype import (set_compute_dtype,
    get_compute_dtype, compute_dtype, resolve_dtype)

__all__ = [
    "median_time",
    "enable_compile_cache",
    "trace",
    "device_timer",
    "calc_A_norm_hat",
    "edge_index_to_adj_matrix",
    "get_few_shot_split",
    "node_subgraph",
    "set_device",
    "shortest_path_distance",
    "batched_shortest_path_distance",
    "degree",
    "add_self_loops",
    "remove_self_loops",
    "contains_self_loops",
    "calc_gcn_norm",
    "calc_gcn_norm_np",
    "mask_to_index",
    "index_to_mask",
    "coalesce",
    "sort_edge_index",
    "to_undirected",
    "is_undirected",
    "subgraph",
    "k_hop_subgraph",
    "to_dense_adj",
    "to_dense_batch",
    "negative_sampling",
    "batched_negative_sampling",
    "structured_negative_sampling",
    "homophily",
    "get_laplacian",
    "to_scipy_sparse_matrix",
    "from_scipy_sparse_matrix",
    "get_train_val_test_split",
    "segment_softmax",
    "shortest_path",
    "from_smiles",
    "manifold_math",
    "UniFewsLogger",
    "ModelLogger",
    "LayerNumLogger",
    "F1Calculator",
    "Stopwatch",
    "gfm_utils",
    "Conversation",
    "conv_templates",
    "get_conv_template",
    "find_all_simple_paths",
    "read_embeddings",
    "save_embeddings",
    "Inspector",
    "threshold_prune",
    "prune_params",
    "rewind",
    "sparsity",
    "prune_edges_by_weight",
    "set_compute_dtype",
    "get_compute_dtype",
    "compute_dtype",
    "resolve_dtype",
]
