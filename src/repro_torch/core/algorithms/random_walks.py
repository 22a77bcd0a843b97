"""Random walks — the paper's highest-speedup workload, local placement.

Pure pointer chasing: every step is two dependent fine-grained reads
(degree / offset from indptr, then the sampled neighbour from the edge
array).  Each step is one `engine.sample_neighbors` pass; this module keeps
only the loop over steps.  The walker-queue form (`run_queue`,
`random_walks_distributed`) is not ported yet (ROADMAP §A.8).
"""
from __future__ import annotations

import torch

from .. import engine
from ..graph import CSR

__all__ = ["random_walks", "random_walks_distributed"]


def random_walks(csr: CSR, starts, n_steps: int, key) -> torch.Tensor:
    """Uniform random walks: (n_walkers, n_steps + 1) int32 node ids on the
    CSR's device, column 0 the starts.

    Walkers at a sink (degree 0) stay in place.  Walker ``w`` draws step
    ``t`` from ``fold_in(fold_in(key, t), w)``, so walkers colliding on a
    vertex stay uncorrelated and a key gives the same walks on the CPU and
    the card.
    """
    dev = csr.device
    k = engine.as_key(key, dev)
    cur = torch.as_tensor(starts, device=dev).to(torch.int32)
    walkers = torch.arange(cur.shape[0], device=dev)
    path = torch.empty((n_steps + 1, cur.shape[0]), dtype=torch.int32,
                       device=dev)
    path[0] = cur
    for t in range(n_steps):
        cur = engine.sample_neighbors(csr, cur, engine.fold_in(
            engine.fold_in(k, t), walkers))
        path[t + 1] = cur
    return path.T.contiguous()


def random_walks_distributed(*args, **kwargs):
    """Walks on the queue engine across ranks: not ported yet (ROADMAP
    §A.8)."""
    raise NotImplementedError("random_walks_distributed (walkers on "
                              "run_queue) is not ported yet (ROADMAP §A.8)")
