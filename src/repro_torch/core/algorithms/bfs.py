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

__all__ = ["bfs", "bfs_program", "bfs_level_program", "msbfs",
           "msbfs_program"]

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


def msbfs_program(n_lanes: int) -> engine.VertexProgram:
    """Multi-source BFS (MS-BFS, Then et al.): one bit lane per source.

    The frontier is the bit-packed (n, W) int32 word array; ``seen`` is the
    OR-accumulated visited mask, and a destination's new lanes are
    ``acc & ~seen`` — B traversals advance per edge scan.  Levels are kept
    unpacked (B, n) so they read out exactly like B separate `bfs` runs.
    """

    def msg_fn(state, frontier):
        return frontier

    def update_fn(state, acc, frontier, it):
        new = acc & ~state["seen"]
        newb = engine.unpack_lanes(new, n_lanes)
        level = torch.where(newb > 0, it + 1, state["level"])
        return {"seen": state["seen"] | new, "level": level}, new

    return engine.VertexProgram(edge_op="copy", combine="or",
                                msg_fn=msg_fn, update_fn=update_fn)


def msbfs(csr: CSR, sources, *, max_levels: int | None = None,
          mode: str = "auto", return_stats: bool = False,
          trace: bool = False, trace_len: Optional[int] = None):
    """Levels (B, n) int32 on the CSR's device for B concurrent BFS
    traversals; unreachable = -1.

    Row b is bit-equal to ``bfs(csr, sources[b])`` — the lanes share every
    edge scan but never interact.  Duplicate sources are allowed (their
    lanes evolve identically).  ``trace`` (with ``return_stats``) records
    the per-level engine trace into ``stats['trace']``.  The levels are
    row-major (the lane words unpack transposed), so a lane's row read back
    to the host is one contiguous run.
    """
    n, dev = csr.n_rows, csr.device
    src = torch.as_tensor(sources, dtype=torch.int64, device=dev)
    B = int(src.shape[0])
    max_levels = max_levels or n
    lanes = torch.arange(B, device=dev)
    bits0 = torch.zeros((B, n), dtype=torch.int32, device=dev)
    bits0[lanes, src] = 1
    f0 = engine.pack_lanes(bits0)
    level0 = torch.full((B, n), -1, dtype=torch.int32, device=dev)
    level0[lanes, src] = 0
    out = engine.run_batched(csr, msbfs_program(B),
                             {"seen": f0, "level": level0}, f0,
                             max_iters=max_levels, mode=mode,
                             return_stats=return_stats, trace=trace,
                             trace_len=trace_len)
    if return_stats:
        state, stats = out
        return state["level"].contiguous(), stats
    return out["level"].contiguous()
