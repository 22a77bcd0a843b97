"""Incremental recompute for monotone programs, local placement.

After a batch of edge inserts, the previous fixpoint of a monotone
(min-combining) program is still a *feasible labeling*: it satisfies the
relaxation inequality on every old edge and can violate it only on the new
edges, whose source endpoints the update report names
(``UpdateReport.changed_sources``).  Re-running the engine with the old
fixpoint as ``state0`` and the changed endpoints as ``frontier0`` is pure
label-correcting repair: the sparse push relaxes outward from the touched
region only, and because the fixpoint of a monotone min-combine does not
depend on the schedule, the repaired labels equal a from-scratch run bit
for bit — f32 min never rounds, and every candidate value is a path
evaluation both schedules generate.

Deletions (and weight *increases*, which are delete + insert in disguise)
break the feasibility invariant, so they fall back to a full recompute;
:func:`repair_or_recompute` logs the decision on the
``repro_torch.streaming`` logger and counts it as
``streaming.full_recompute_fallback`` in the port's registry
(`repro_torch.obs.get_registry`).

The repair functions take and return the same tensors as their
from-scratch counterparts (``bfs`` levels, ``connected_components``
labels, ``sssp`` distances), on the CSR's device.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from .. import engine
from ..graph import CSR, GraphHandle, UpdateReport
from ...obs import get_registry
from .bfs import _levels_from_dist, bfs_level_program
from .cc import cc_program, symmetrize
from .sssp import auto_delta, sssp_program

__all__ = ["bfs_repair", "cc_repair", "sssp_repair", "repair_or_recompute",
           "bfs_repair_distributed", "cc_repair_distributed"]

log = logging.getLogger("repro_torch.streaming")

_INF = float("inf")


def _indicator(n: int, vertices, device) -> torch.Tensor:
    """(n,) int32 with 1 at ``vertices`` (a host array of ids)."""
    out = torch.zeros(n, dtype=torch.int32, device=device)
    v = torch.as_tensor(np.asarray(vertices, np.int64), device=device)
    out[v] = 1
    return out


def bfs_repair(csr: CSR, prev_levels, changed, *, mode: str = "auto",
               max_levels: Optional[int] = None) -> torch.Tensor:
    """Repair BFS levels after an insert-only batch.

    csr: the UPDATED graph.  prev_levels: (n,) int32 levels on the
    pre-update graph (unreachable = -1, i.e. ``bfs`` output).  changed:
    source endpoints of the inserted edges.  Returns levels bit-identical
    to ``bfs(csr, source)`` on the updated graph.

    Repair runs the monotone :func:`bfs_level_program` (min hop distance)
    — the iteration-stamped ``bfs_program`` depends on the order and cannot
    be warm-started — but both compute the exact hop distance.
    """
    n, dev = csr.n_rows, csr.device
    prev = torch.as_tensor(prev_levels, device=dev)
    dist0 = torch.where(prev >= 0, prev.to(torch.float32), _INF)
    # only changed endpoints the old traversal reached can push improvements
    f0 = _indicator(n, changed, dev) * torch.isfinite(dist0).to(torch.int32)
    state = engine.run(csr, bfs_level_program(), {"dist": dist0}, f0,
                       max_iters=max_levels or n, mode=mode)
    return _levels_from_dist(state["dist"])


def cc_repair(csr: CSR, prev_labels, changed, *, mode: str = "auto",
              symmetrize_input: bool = True,
              max_iters: Optional[int] = None) -> torch.Tensor:
    """Repair connected-component labels after an insert-only batch.

    csr: the UPDATED graph (symmetrized here by default, matching
    ``connected_components``).  changed: endpoints of inserted edges —
    pass BOTH sides (``UpdateReport.changed_vertices``): components are
    undirected, so either endpoint's label can be the one that shrinks.
    """
    g = symmetrize(csr) if symmetrize_input else csr
    n, dev = g.n_rows, g.device
    state0 = {"label": torch.as_tensor(prev_labels, device=dev).to(
        torch.int32)}
    state = engine.run(g, cc_program(), state0, _indicator(n, changed, dev),
                       max_iters=max_iters if max_iters is not None else n,
                       mode=mode)
    return state["label"]


def sssp_repair(csr: CSR, prev_dist, changed, *,
                max_iters: Optional[int] = None,
                mode: str = "auto") -> torch.Tensor:
    """Repair SSSP distances after a batch of inserts / weight decreases.

    csr: the UPDATED graph.  prev_dist: (n,) f32 distances on the
    pre-update graph (unreachable = +inf).  changed: source endpoints of
    the changed edges.  Returns distances bit-identical to
    ``sssp(csr, source)``: the (min, +) fixpoint does not depend on the
    schedule, so the repair wave (bound = inf: every pending vertex stays
    active, no bucket pacing) lands on the same f32 values as scratch
    delta-stepping at any delta.
    """
    n, dev = csr.n_rows, csr.device
    dist0 = torch.as_tensor(prev_dist, device=dev).to(torch.float32)
    seeds = _indicator(n, changed, dev) * \
        torch.isfinite(dist0).to(torch.int32)
    state0 = {"dist": dist0, "pending": seeds.to(torch.bool),
              "bound": torch.tensor(_INF, dtype=torch.float32, device=dev)}
    state = engine.run(csr, sssp_program(_INF), state0, seeds,
                       max_iters=max_iters if max_iters is not None else 4 * n,
                       mode=mode)
    return state["dist"]


def repair_or_recompute(kind: str, handle: GraphHandle, prev,
                        report: UpdateReport, *, source: int = 0,
                        mode: str = "auto"):
    """Dispatch: incremental repair when the batch was monotone-safe, else
    the logged and counted full-recompute fallback.

    kind: 'bfs' | 'cc' | 'sssp'.  prev: the pre-update result for `kind`
    (ignored on fallback).  Returns the post-update result either way.  The
    fallback's SSSP takes the port's ``auto_delta`` (which differs from the
    reference's by design); the distances are a fixpoint, so they do not
    depend on delta.
    """
    from .bfs import bfs
    from .cc import connected_components
    from .sssp import sssp

    if kind not in ("bfs", "cc", "sssp"):
        raise ValueError(f"unknown repair kind {kind!r}")
    csr = handle.csr
    if report.monotone_safe:
        log.info("epoch %d: %s repair from %d changed endpoints "
                 "(+%d edges, %d upserts)", report.epoch, kind,
                 report.changed_sources.size, report.n_inserted,
                 report.n_upserted)
        if kind == "bfs":
            return bfs_repair(csr, prev, report.changed_sources, mode=mode)
        if kind == "cc":
            return cc_repair(csr, prev, report.changed_vertices, mode=mode)
        return sssp_repair(csr, prev, report.changed_sources, mode=mode)
    log.info("epoch %d: %s full recompute fallback (%d deletes, "
             "weight increases=%s — old fixpoint not feasible)",
             report.epoch, kind, report.n_deleted, report.n_deleted == 0)
    get_registry().counter("streaming.full_recompute_fallback").inc()
    if kind == "bfs":
        return bfs(csr, source, mode=mode)
    if kind == "cc":
        return connected_components(csr, mode=mode)
    return sssp(csr, source, delta=auto_delta(csr), mode=mode)


def _changed_rows(att, changed, mesh) -> torch.Tensor:
    """(per_shard,) int32 indicator of this rank's rows among the global
    ids ``changed`` (a host array)."""
    f0 = torch.zeros(att.per_shard, dtype=torch.int32, device=mesh.device)
    ch = torch.as_tensor(np.asarray(changed, np.int64).reshape(-1))
    if ch.numel():
        mine = att.owner(ch) == mesh.rank
        f0[att.local(ch[mine]).to(mesh.device)] = 1
    return f0


def bfs_repair_distributed(g, att, prev_levels, changed, mesh, *, axis=None,
                           max_levels: int = 64, placement: str = "sync",
                           sync_interval: Optional[int] = None
                           ) -> torch.Tensor:
    """Distributed :func:`bfs_repair` on one rank of ``mesh``: ``g`` the
    UPDATED sharded graph (``update_shards``), ``prev_levels`` this rank's
    (per_shard,) rows of ``bfs_distributed``'s levels, ``changed`` the
    global source endpoints of the inserted edges (the same host array on
    every rank).  Returns this rank's repaired levels: the min-level
    fixpoint, bit-equal to a fresh distributed BFS and to the local
    repair."""
    mesh = mesh.over(axis)
    prev = torch.as_tensor(prev_levels, device=mesh.device)
    dist0 = torch.where(prev >= 0, prev.to(torch.float32), _INF)
    f0 = _changed_rows(att, changed, mesh) * \
        torch.isfinite(dist0).to(torch.int32)
    k = int(sync_interval or 8) if placement == "async" else 1
    state = engine.run_distributed(
        g, att, mesh, bfs_level_program(), {"dist": dist0}, f0,
        max_iters=max_levels * k, mode="push", placement=placement,
        sync_interval=sync_interval)
    return _levels_from_dist(state["dist"])


def cc_repair_distributed(g, att, prev_labels, changed, mesh, *, axis=None,
                          max_iters: int = 256, placement: str = "sync",
                          sync_interval: Optional[int] = None
                          ) -> torch.Tensor:
    """Distributed :func:`cc_repair` on one rank of ``mesh``: ``g`` must
    hold the UPDATED *symmetric* edge set (sharded from ``symmetrize(
    csr)``), ``prev_labels`` this rank's (per_shard,) rows, ``changed``
    both endpoints of the inserted edges (global ids).  Returns this rank's
    repaired labels, bit-equal to a fresh distributed run."""
    mesh = mesh.over(axis)
    state0 = {"label": torch.as_tensor(prev_labels, device=mesh.device).to(
        torch.int32)}
    state = engine.run_distributed(
        g, att, mesh, cc_program(), state0, _changed_rows(att, changed, mesh),
        max_iters=max_iters, mode="push", placement=placement,
        sync_interval=sync_interval)
    return state["label"]
