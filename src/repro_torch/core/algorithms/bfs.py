"""Breadth-first search, as a :mod:`repro_torch.core.engine` vertex program.

The program: active vertices emit an indicator along out-edges; a destination
combining a positive count for the first time is assigned the next level and
joins the frontier.  Direction optimization (push the sparse frontier, pull
once it saturates) is the engine's job, not BFS's.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import engine
from ..graph import CSR, BBCSR

__all__ = ["bfs", "bfs_program", "bfs_level_program"]

_INF = float("inf")


def bfs_program() -> engine.VertexProgram:
    """Levels in state['level'], int32 frontier indicator as the message."""

    def msg_fn(state, frontier):
        return frontier.to(torch.int32)

    def update_fn(state, acc, frontier, it):
        new = (acc > 0) & (state["level"] < 0)
        level = torch.where(new, it + 1, state["level"])
        return {"level": level}, new.to(torch.int32)

    return engine.VertexProgram(edge_op="copy", combine="add",
                                msg_fn=msg_fn, update_fn=update_fn)


def bfs(csr: CSR, source: int, *, max_levels: int | None = None,
        mode: str = "auto", kernel_bb: Optional[BBCSR] = None) -> torch.Tensor:
    """Returns level array (n,) int32 on the CSR's device; unreachable = -1.

    mode: 'auto' (direction-optimizing, default) | 'push' | 'pull'.
    kernel_bb: optional BBCSR of A^T to run both directions on the BBCSR
      SpMV/SpMSpV kernels; must be unit-valued — build it with
      engine.build_pull_operand(csr, unit_values=True).
    """
    n, dev = csr.n_rows, csr.device
    max_levels = max_levels or n
    level0 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    level0[source] = 0
    frontier0 = torch.zeros(n, dtype=torch.int32, device=dev)
    frontier0[source] = 1
    state = engine.run(csr, bfs_program(), {"level": level0}, frontier0,
                       max_iters=max_levels, mode=mode, kernel_bb=kernel_bb)
    return state["level"]


def bfs_level_program() -> engine.VertexProgram:
    """Monotone min-level BFS: the state is a float distance (levels are
    small ints, exact in f32), active vertices emit ``dist + 1`` and
    destinations keep the **min** — the unit-weight (min, +) semiring,
    whose fixpoint is the hop distance in any message order.  Convert with
    :func:`_levels_from_dist` to match :func:`bfs_program` levels."""

    def msg_fn(state, frontier):
        return torch.where(frontier > 0, state["dist"] + 1.0, _INF)

    def update_fn(state, acc, frontier, it):
        better = acc < state["dist"]
        return ({"dist": torch.minimum(state["dist"], acc)},
                better.to(torch.int32))

    return engine.VertexProgram(edge_op="copy", combine="min",
                                msg_fn=msg_fn, update_fn=update_fn)


def _levels_from_dist(dist: torch.Tensor) -> torch.Tensor:
    """f32 min-level fixpoint -> int32 levels, unreachable = -1."""
    return torch.where(torch.isfinite(dist), dist, -1.0).to(torch.int32)
