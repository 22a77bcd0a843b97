"""The paper's own workload configs: RMAT scales + algorithm selections
(the reference's values; no model)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GraphWorkloadConfig:
    rmat_scale: int = 14
    edge_factor: int = 16
    pagerank_iters: int = 20
    bfs_max_levels: int = 32
    walkers: int = 4096
    walk_steps: int = 16
    lpa_iters: int = 8
    spmv_block_rows: int = 256
    spmv_block_cols: int = 512
    spmv_tile_nnz: int = 512


def config() -> GraphWorkloadConfig:
    return GraphWorkloadConfig()
