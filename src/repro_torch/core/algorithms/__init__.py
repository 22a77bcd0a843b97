from .spmv import spmv, spmv_ell, spmv_bbcsr
from .spmspv import spmspv, spmspv_ell
from .pagerank import pagerank, ppr, ppr_program
from .bfs import bfs, bfs_program, bfs_level_program
from .sssp import sssp, sssp_program, auto_delta
from .cc import connected_components, cc_program, symmetrize

__all__ = [
    "spmv", "spmv_ell", "spmv_bbcsr",
    "spmspv", "spmspv_ell",
    "pagerank", "ppr", "ppr_program",
    "bfs", "bfs_program", "bfs_level_program",
    "sssp", "sssp_program", "auto_delta",
    "connected_components", "cc_program", "symmetrize",
]
