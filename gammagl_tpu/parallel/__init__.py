"""Multi-chip execution: meshes, graph partitioning, sharded kernels.

Net-new relative to the reference (it has no distributed training,
SURVEY.md section 2.10). All scale-out is expressed through
`jax.sharding.Mesh` + `shard_map` with XLA collectives.
"""

from gammagl_tpu.parallel.mesh import (make_mesh, replicate, shard,
                                       PartitionSpec, NamedSharding)
from gammagl_tpu.parallel.partition import (EdgePartition,
                                            balance_permutation,
                                            partition_edges_by_dst,
                                            partition_edges_uniform)
from gammagl_tpu.parallel.spmm import sharded_spmm, make_sharded_spmm
from gammagl_tpu.parallel.halo import (HaloPartition, build_halo_partition,
                                       make_halo_spmm, reorder_bandwidth)
from gammagl_tpu.parallel.hier_halo import (HierHaloPartition,
                                            build_hier_halo_partition,
                                            make_hier_halo_spmm,
                                            traffic_report)
from gammagl_tpu.parallel.halo_attention import (
    AttnHaloPartition, build_halo_partition_attn,
    make_partitioned_gat_layer)

from gammagl_tpu.parallel.strategies import (
    pipeline_apply, make_pipeline_apply, shard_pipeline_params,
    make_feature_sharded_spmm, relation_expert_spmm,
    make_relation_expert_spmm, shard_expert_weights)
from gammagl_tpu.parallel.scaling import (HwModel, PEAKS, hw_model,
                                          halo_scaling_estimate)
from gammagl_tpu.parallel.full_graph import (pad_nodes, unpad_nodes,
                                             shard_nodes,
                                             sign_precompute,
                                             make_partitioned_gcn_train,
                                             make_partitioned_gcn_train_staged,
                                             make_partitioned_gat_train,
                                             estimate_hbm_gb)

__all__ = [
    "make_mesh",
    "replicate",
    "shard",
    "PartitionSpec",
    "NamedSharding",
    "EdgePartition",
    "partition_edges_by_dst",
    "partition_edges_uniform",
    "balance_permutation",
    "sharded_spmm",
    "make_sharded_spmm",
    "HaloPartition",
    "build_halo_partition",
    "make_halo_spmm",
    "reorder_bandwidth",
    "HierHaloPartition",
    "build_hier_halo_partition",
    "make_hier_halo_spmm",
    "traffic_report",
    "AttnHaloPartition",
    "build_halo_partition_attn",
    "make_partitioned_gat_layer",
    "pipeline_apply",
    "make_feature_sharded_spmm",
    "relation_expert_spmm",
    "make_relation_expert_spmm",
    "shard_expert_weights",
    "make_pipeline_apply",
    "shard_pipeline_params",
    "pad_nodes",
    "unpad_nodes",
    "shard_nodes",
    "sign_precompute",
    "make_partitioned_gcn_train",
    "make_partitioned_gcn_train_staged",
    "make_partitioned_gat_train",
    "estimate_hbm_gb",
    "HwModel",
    "PEAKS",
    "hw_model",
    "halo_scaling_estimate",
]
