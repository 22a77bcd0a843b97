from .spmv import spmv, spmv_ell, spmv_bbcsr, spmv_distributed
from .spmspv import spmspv, spmspv_ell
from .pagerank import (pagerank, ppr, ppr_batched, ppr_topk, ppr_program,
                       pagerank_distributed)
from .bfs import (bfs, bfs_program, bfs_level_program, msbfs, msbfs_program,
                  bfs_distributed, msbfs_distributed)
from .sssp import (sssp, sssp_program, auto_delta, sssp_batched,
                   sssp_distributed, sssp_batched_distributed)
from .cc import (connected_components, cc_program, symmetrize,
                 connected_components_distributed)
from .random_walks import (random_walks, random_walks_distributed,
                           walk_queue_program, walk_shards)
from .louvain import (label_propagation, lpa_program,
                      louvain_candidate_program, louvain_local_moves,
                      modularity, multilevel, partition_equal,
                      label_propagation_distributed, modularity_distributed,
                      contract_distributed, multilevel_distributed)
from .sampling import ties_sample, neighbor_sample, neighbor_sample_np
from .incremental import (bfs_repair, cc_repair, sssp_repair,
                          repair_or_recompute, bfs_repair_distributed,
                          cc_repair_distributed)
from .distgraph import (ShardedGraph, GraphShard, shard_graph, shard_of,
                        shard_vertex_array, unshard_vertex_array,
                        update_shards)

__all__ = [
    "spmv", "spmv_ell", "spmv_bbcsr",
    "spmspv", "spmspv_ell",
    "pagerank", "ppr", "ppr_batched", "ppr_topk", "ppr_program",
    "bfs", "bfs_program", "bfs_level_program", "msbfs", "msbfs_program",
    "sssp", "sssp_program", "auto_delta", "sssp_batched",
    "connected_components", "cc_program", "symmetrize",
    "random_walks",
    "label_propagation", "lpa_program", "louvain_candidate_program",
    "louvain_local_moves", "modularity", "multilevel", "partition_equal",
    "ties_sample", "neighbor_sample", "neighbor_sample_np",
    "bfs_repair", "cc_repair", "sssp_repair", "repair_or_recompute",
    "spmv_distributed", "pagerank_distributed", "bfs_distributed",
    "msbfs_distributed", "sssp_distributed", "sssp_batched_distributed",
    "connected_components_distributed", "label_propagation_distributed",
    "random_walks_distributed", "walk_queue_program", "walk_shards",
    "modularity_distributed",
    "contract_distributed", "multilevel_distributed",
    "bfs_repair_distributed", "cc_repair_distributed",
    "ShardedGraph", "GraphShard", "shard_graph", "shard_of",
    "shard_vertex_array",
    "unshard_vertex_array", "update_shards",
]
