"""Quickstart on the torch port: PIUMA-style graph analytics in a few lines.

Builds an RMAT graph, runs the paper's core workloads through the offload
engines, SpMV through the BBCSR kernel (B1), and prints the Table I
staging from the analytical machine model.  Runs on the card unless given
``--device cpu`` (there the kernel's plain version runs).

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

``main(argv)`` returns the numbers it prints.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.core import rmat, to_bbcsr
from repro_torch.core.algorithms import bfs, pagerank, random_walks, spmv
from repro_torch.core.traffic import SPMV_PROFILES, speedup
from repro_torch.kernels import ops

PROFILES = ("piuma_base", "piuma_selective", "piuma_dma", "piuma_cache_all")


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=10,
                    help="RMAT scale: 2**scale vertices, 16 edges each")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    g = rmat(args.scale, 16, seed=0, device=dev)
    print(f"graph: {g.n_rows} vertices, {g.nnz} edges")

    # SpMV two ways: fine-grained gather, and the DMA-gather BBCSR kernel
    x = torch.as_tensor(np.random.default_rng(0).random(g.n_cols, np.float32),
                        device=dev)
    y = spmv(g, x)
    bb = to_bbcsr(g, block_rows=256, block_cols=256, tile_nnz=256)
    y_kernel = ops.spmv_dma(bb, x)
    spmv_diff = float((y - y_kernel[:g.n_rows]).abs().max())
    print(f"SpMV max |base - DMA kernel| = {spmv_diff:.2e}")

    pr = pagerank(g, iters=20)
    pr_sum, pr_top = float(pr.sum()), int(pr.argmax())
    print(f"PageRank: sum={pr_sum:.4f}, top vertex={pr_top}")

    lv = bfs(g, 0)
    reached, depth = int((lv >= 0).sum()), int(lv.max())
    print(f"BFS from 0: reached {reached} vertices, max level {depth}")

    walks = random_walks(g, torch.arange(8, device=dev), 5, 0)
    print(f"random walk[0]: {walks[0].tolist()}")

    print("\nTable I machine model (PIUMA node vs 4-socket Xeon):")
    table = {}
    for name in PROFILES:
        table[name] = speedup(SPMV_PROFILES[name])
        print(f"  {name:18s} {table[name]:5.1f}x")
    return {"n_vertices": g.n_rows, "n_edges": g.nnz, "spmv_diff": spmv_diff,
            "levels": lv.cpu().numpy(), "pagerank": pr.cpu().numpy(),
            "pagerank_sum": pr_sum, "pagerank_top": pr_top,
            "bfs_reached": reached, "bfs_depth": depth,
            "walk0": walks[0].tolist(), "table1": table}


if __name__ == "__main__":
    main()
