"""Breadth-first search, as a :mod:`repro_torch.core.engine` vertex program.

The program: active vertices emit an indicator along out-edges; a destination
combining a positive count for the first time is assigned the next level and
joins the frontier.  Direction optimization (push the sparse frontier, pull
once it saturates) is the engine's job, not BFS's.  Distributed, push
expands through remote atomics at the dst owner and pull gathers via
fine-grained dgas reads over the reversed edge shards; each rank runs the
call on its own (per_shard,) rows.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import engine
from ..graph import CSR, BBCSR

__all__ = ["bfs", "bfs_program", "bfs_level_program", "msbfs",
           "msbfs_program", "bfs_distributed", "msbfs_distributed",
           "source_rows"]

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


# ---------------------------------------------------------------------------
# Distributed (one rank of a launch.mesh.Mesh; rows per the vertex ATT)
# ---------------------------------------------------------------------------

def source_rows(att, sources, mesh):
    """The sources this rank owns: (lane indices, local offsets) as int64
    tensors on the mesh's device."""
    src = torch.as_tensor(np.asarray(sources, dtype=np.int64).reshape(-1))
    mine = att.owner(src) == mesh.rank
    lanes = torch.arange(src.shape[0])[mine]
    return lanes.to(mesh.device), att.local(src[mine]).to(mesh.device)


def bfs_distributed(g, att, source: int, mesh, *, max_levels: int = 64,
                    g_rev=None, mode: str = "push", placement: str = "sync",
                    sync_interval: Optional[int] = None,
                    return_stats: bool = False, axis=None):
    """This rank's (per_shard,) int32 levels under ``att``; unreachable =
    -1.  ``g`` is sharded by ``att`` (``shard_graph(csr, S, row_att=att)``
    or its rank's shard).

    mode='push' expands through remote atomics; pass ``g_rev``
    (``engine.reverse_graph``) with mode='auto' for the direction-
    optimizing variant.  placement='async' (push-only) runs the monotone
    :func:`bfs_level_program` with bounded-staleness pacing: the same
    levels, ``sync_interval`` x fewer global checks.  ``return_stats``
    adds the engine's stats (``engine.run_distributed``).
    """
    mesh = mesh.over(axis)
    per, dev = att.per_shard, mesh.device
    _, local = source_rows(att, [source], mesh)
    frontier0 = torch.zeros(per, dtype=torch.int32, device=dev)
    frontier0[local] = 1
    if placement == "async":
        k = int(sync_interval) if sync_interval is not None else 8
        dist0 = torch.full((per,), _INF, device=dev)
        dist0[local] = 0.0
        out = engine.run_distributed(
            g, att, mesh, bfs_level_program(), {"dist": dist0}, frontier0,
            max_iters=max_levels * k, mode=mode, placement="async",
            sync_interval=k, return_stats=return_stats)
        state, stats = out if return_stats else (out, None)
        levels = _levels_from_dist(state["dist"])
    else:
        level0 = torch.full((per,), -1, dtype=torch.int32, device=dev)
        level0[local] = 0
        out = engine.run_distributed(g, att, mesh, bfs_program(),
                                     {"level": level0}, frontier0,
                                     max_iters=max_levels, g_rev=g_rev,
                                     mode=mode, return_stats=return_stats)
        state, stats = out if return_stats else (out, None)
        levels = state["level"]
    return (levels, stats) if return_stats else levels


def msbfs_distributed(g, att, sources, mesh, *, max_levels: int = 64,
                      push_edge_capacity: Optional[int] = None,
                      return_stats: bool = False, placement: str = "sync",
                      sync_interval: Optional[int] = None,
                      trace: bool = False, trace_len: Optional[int] = None,
                      axis=None):
    """Batched-lane BFS on the distributed push pipeline: this rank's
    (B, per_shard) int32 levels under ``att``; row b equals
    ``bfs_distributed(g, att, sources[b], mesh)`` bit for bit.  One
    compacted exchange per level carries all B lanes as packed words
    (``offload.remote_scatter_or``, the ``segment_or`` kernel at the owner
    on the card).

    placement='async' runs the monotone :func:`bfs_level_program` on
    vmapped valued lanes instead (the packed program's first-touch level
    stamp depends on delivery order; the min-level fixpoint does not),
    with ``sync_interval`` local micro-steps per global check.
    """
    mesh = mesh.over(axis)
    per, dev = att.per_shard, mesh.device
    B = int(np.asarray(sources).reshape(-1).shape[0])
    lanes, local = source_rows(att, sources, mesh)
    if placement == "async":
        k = int(sync_interval) if sync_interval is not None else 8
        dist0 = torch.full((B, per), _INF, device=dev)
        dist0[lanes, local] = 0.0
        f0 = torch.zeros((B, per), dtype=torch.int32, device=dev)
        f0[lanes, local] = 1
        out = engine.run_batched_distributed(
            g, att, mesh, bfs_level_program(), {"dist": dist0}, f0,
            max_iters=max_levels * k, push_edge_capacity=push_edge_capacity,
            return_stats=return_stats, placement="async", sync_interval=k,
            trace=trace, trace_len=trace_len)
        if return_stats:
            state, stats = out
            return _levels_from_dist(state["dist"]), stats
        return _levels_from_dist(out["dist"])
    bits = torch.zeros((B, per), dtype=torch.int32, device=dev)
    bits[lanes, local] = 1
    words0 = engine.pack_lanes(bits)
    level0 = torch.full((B, per), -1, dtype=torch.int32, device=dev)
    level0[lanes, local] = 0
    out = engine.run_batched_distributed(
        g, att, mesh, msbfs_program(B), {"seen": words0, "level": level0},
        words0, max_iters=max_levels, push_edge_capacity=push_edge_capacity,
        return_stats=return_stats, trace=trace, trace_len=trace_len)
    if return_stats:
        state, stats = out
        return state["level"].contiguous(), stats
    return out["level"].contiguous()
