"""Single-source shortest paths — delta-stepping-style, on the frontier engine.

The vertex program is the (min, +) semiring: active vertices emit their
tentative distance, every edge adds its weight, destinations keep the min.
On top of that the update rule implements delta-stepping's bucket discipline:
only *pending* vertices (improved since last expanded) whose distance falls
inside the current bucket ``[0, bound)`` join the frontier; when the bucket
drains, ``bound`` advances to ``min(pending dist) + delta``.

Weights must be non-negative; an unweighted graph relaxes with unit weights
(== BFS distances).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import engine
from ..graph import CSR
from ... import tune

__all__ = ["sssp", "sssp_program", "auto_delta", "sssp_batched"]

_INF = float("inf")


def sssp_program(delta: float, *, global_min=None) -> engine.VertexProgram:
    """(min, +) relaxation with bucketed frontier admission.

    global_min: optional f(x)->x reduction for a placement that must agree
      on `min(pending dist)` across shards (identity here).
    """
    gmin = global_min if global_min is not None else (lambda x: x)

    def msg_fn(state, frontier):
        return torch.where(frontier > 0, state["dist"], _INF)

    def update_fn(state, acc, frontier, it):
        dist, pending, bound = state["dist"], state["pending"], state["bound"]
        relaxed = acc < dist
        dist = torch.minimum(dist, acc)
        pending = (pending & (frontier == 0)) | relaxed
        in_bucket = pending & (dist <= bound)
        minpend = gmin(torch.where(pending, dist, _INF).min())
        bucket_empty = gmin(torch.where(in_bucket, 0.0, 1.0).min()) > 0.5
        bound = torch.where(torch.isfinite(minpend) & bucket_empty,
                            minpend + delta, bound)
        new_frontier = pending & (dist <= bound)
        return ({"dist": dist, "pending": pending, "bound": bound},
                new_frontier.to(torch.int32))

    return engine.VertexProgram(edge_op="add", combine="min",
                                msg_fn=msg_fn, update_fn=update_fn)


def auto_delta(csr: CSR, *, bins: int = 64, light_edges_per_vertex: float = 4.0,
               scaled: bool = True) -> float:
    """Delta from the weight histogram: the weight quantile at which the
    expected number of sub-delta ("light") edges per vertex reaches
    ``light_edges_per_vertex``, read off a ``bins``-bin histogram CDF.

    scaled: multiply by the ``sssp.delta_scale`` tunable.  Unweighted (and
    empty) graphs return exactly 1.0.
    """
    if csr.values is None or csr.nnz == 0:
        return 1.0
    w = csr.values.cpu().numpy()
    mul = tune.resolve("sssp.delta_scale") if scaled else 1.0
    avg_deg = max(1.0, csr.nnz / max(1, csr.n_rows))
    hist, edges = np.histogram(w, bins=bins)
    cdf = np.cumsum(hist) / max(1, w.size)
    q = min(1.0, light_edges_per_vertex / avg_deg)
    return float(max(edges[min(int(np.searchsorted(cdf, q)) + 1,
                               len(edges) - 1)], 1e-6)) * mul


def sssp(csr: CSR, source: int, *, delta: Optional[float] = None,
         max_iters: Optional[int] = None, mode: str = "auto",
         return_stats: bool = False):
    """Returns (n,) float32 distances on the CSR's device; unreachable = +inf.

    delta: bucket width; None auto-tunes from the weight histogram
      (:func:`auto_delta`).
    """
    n, dev = csr.n_rows, csr.device
    delta = delta if delta is not None else auto_delta(csr)
    max_iters = max_iters if max_iters is not None else 4 * n
    dist0 = torch.full((n,), _INF, dtype=torch.float32, device=dev)
    dist0[source] = 0.0
    pending0 = torch.zeros(n, dtype=torch.bool, device=dev)
    pending0[source] = True
    state0 = {"dist": dist0, "pending": pending0,
              "bound": torch.tensor(delta, dtype=torch.float32, device=dev)}
    frontier0 = torch.zeros(n, dtype=torch.int32, device=dev)
    frontier0[source] = 1
    out = engine.run(csr, sssp_program(delta), state0, frontier0,
                     max_iters=max_iters, mode=mode, return_stats=return_stats)
    if return_stats:
        state, stats = out
        return state["dist"], stats
    return out["dist"]


def sssp_batched(csr: CSR, sources, *, delta: Optional[float] = None,
                 max_iters: Optional[int] = None, mode: str = "auto",
                 kernel_bb=None, return_stats: bool = False,
                 trace: bool = False, trace_len: Optional[int] = None):
    """Distances (B, n) float32 on the CSR's device for B concurrent
    single-source runs.

    The *same* ``sssp_program`` drives every lane (the engine vmaps it), so
    row b is bit-equal to ``sssp(csr, sources[b], delta=delta)`` — each lane
    keeps its own bucket bound and drains independently while the (min, +)
    relaxations of all lanes ride one shared edge scan.  ``delta`` is shared
    across the batch.
    kernel_bb: optional weighted BBCSR of A^T (``engine.build_pull_operand``
      with ``combine='min'``) to run the relaxations on the (min,+) SpMSpV
      kernel, one launch per lane per level.
    """
    n, dev = csr.n_rows, csr.device
    src = torch.as_tensor(sources, dtype=torch.int64, device=dev)
    B = int(src.shape[0])
    delta = delta if delta is not None else auto_delta(csr)
    max_iters = max_iters if max_iters is not None else 4 * n
    lanes = torch.arange(B, device=dev)
    dist0 = torch.full((B, n), _INF, dtype=torch.float32, device=dev)
    dist0[lanes, src] = 0.0
    pending0 = torch.zeros((B, n), dtype=torch.bool, device=dev)
    pending0[lanes, src] = True
    frontier0 = torch.zeros((B, n), dtype=torch.int32, device=dev)
    frontier0[lanes, src] = 1
    state0 = {"dist": dist0, "pending": pending0,
              "bound": torch.full((B,), delta, dtype=torch.float32,
                                  device=dev)}
    out = engine.run_batched(csr, sssp_program(delta), state0, frontier0,
                             max_iters=max_iters, mode=mode,
                             kernel_bb=kernel_bb, return_stats=return_stats,
                             trace=trace, trace_len=trace_len)
    if return_stats:
        state, stats = out
        return state["dist"], stats
    return out["dist"]
