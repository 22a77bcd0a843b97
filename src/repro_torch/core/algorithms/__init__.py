from .spmv import spmv, spmv_ell, spmv_bbcsr
from .spmspv import spmspv, spmspv_ell
from .pagerank import pagerank, ppr, ppr_batched, ppr_topk, ppr_program
from .bfs import bfs, bfs_program, bfs_level_program, msbfs, msbfs_program
from .sssp import sssp, sssp_program, auto_delta, sssp_batched
from .cc import connected_components, cc_program, symmetrize

__all__ = [
    "spmv", "spmv_ell", "spmv_bbcsr",
    "spmspv", "spmspv_ell",
    "pagerank", "ppr", "ppr_batched", "ppr_topk", "ppr_program",
    "bfs", "bfs_program", "bfs_level_program", "msbfs", "msbfs_program",
    "sssp", "sssp_program", "auto_delta", "sssp_batched",
    "connected_components", "cc_program", "symmetrize",
]
