"""PageRank and personalized PageRank as dense-frontier
:mod:`repro_torch.core.engine` vertex programs.

The frontier never shrinks (every vertex pushes mass every iteration), so the
engine runs the dense direction throughout (locally; distributed, every
level pushes at full capacity).
"""
from __future__ import annotations

import torch

from .. import engine, offload
from ..graph import CSR
from .distgraph import local_shard

__all__ = ["pagerank", "ppr", "ppr_batched", "ppr_topk", "ppr_program",
           "pagerank_distributed"]


def _inv_degrees(csr: CSR):
    deg = csr.degrees().to(torch.float32)
    return deg, torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1), 0.0)


def pagerank(csr: CSR, *, damping: float = 0.85, iters: int = 20) -> torch.Tensor:
    n = csr.n_rows
    deg, inv_deg = _inv_degrees(csr)

    def msg_fn(state, frontier):
        return state["x"] * inv_deg

    def update_fn(state, acc, frontier, it):
        x = state["x"]
        dangling = torch.where(deg > 0, 0.0, x).sum()  # redistribute sinks
        x = (1 - damping) / n + damping * (acc + dangling / n)
        return {"x": x}, frontier

    prog = engine.VertexProgram(edge_op="copy", combine="add",
                                msg_fn=msg_fn, update_fn=update_fn)
    state0 = {"x": torch.full((n,), 1.0 / n, dtype=torch.float32,
                              device=csr.device)}
    frontier0 = torch.ones(n, dtype=torch.int32, device=csr.device)
    return engine.run(csr, prog, state0, frontier0, max_iters=iters,
                      mode="pull")["x"]


def ppr_program(csr: CSR, damping: float) -> engine.VertexProgram:
    """Personalized PageRank: the restart vector rides in ``state['r']`` (so
    the batched engine's lane vmap personalizes it per source); dangling
    mass also restarts to r."""
    deg, inv_deg = _inv_degrees(csr)

    def msg_fn(state, frontier):
        return state["x"] * inv_deg

    def update_fn(state, acc, frontier, it):
        x, r = state["x"], state["r"]
        dangling = torch.where(deg > 0, 0.0, x).sum()
        x = (1 - damping) * r + damping * (acc + dangling * r)
        return {"x": x, "r": r}, frontier

    return engine.VertexProgram(edge_op="copy", combine="add",
                                msg_fn=msg_fn, update_fn=update_fn)


def ppr(csr: CSR, source: int, *, damping: float = 0.85,
        iters: int = 20) -> torch.Tensor:
    """Personalized PageRank from one source; (n,) float32 scores."""
    n = csr.n_rows
    r = torch.zeros(n, dtype=torch.float32, device=csr.device)
    r[source] = 1.0
    frontier0 = torch.ones(n, dtype=torch.int32, device=csr.device)
    return engine.run(csr, ppr_program(csr, damping), {"x": r, "r": r},
                      frontier0, max_iters=iters, mode="pull")["x"]


def ppr_batched(csr: CSR, sources, *, damping: float = 0.85,
                iters: int = 20, return_stats: bool = False,
                trace: bool = False, trace_len=None):
    """Personalized PageRank for B sources in one engine pass; (B, n) f32.

    The vmapped lanes share each dense edge scan (PPR never leaves the pull
    regime) and personalize the restart vector per lane via the state.
    ``return_stats`` adds the engine's {'iters', 'pushes', 'pulls'}.  (The
    BBCSR kernel path is ``engine.run_batched(csr, ppr_program(csr,
    damping), ..., mode='pull', kernel_bb=unit operand)``.)
    """
    n, dev = csr.n_rows, csr.device
    src = torch.as_tensor(sources, dtype=torch.int64, device=dev)
    B = int(src.shape[0])
    r = torch.zeros((B, n), dtype=torch.float32, device=dev)
    r[torch.arange(B, device=dev), src] = 1.0
    frontier0 = torch.ones((B, n), dtype=torch.int32, device=dev)
    out = engine.run_batched(csr, ppr_program(csr, damping),
                             {"x": r, "r": r}, frontier0, max_iters=iters,
                             mode="pull", return_stats=return_stats,
                             trace=trace, trace_len=trace_len)
    if return_stats:
        state, stats = out
        return state["x"], stats
    return out["x"]


def ppr_topk(csr: CSR, sources, k: int, *, damping: float = 0.85,
             iters: int = 20, return_stats: bool = False,
             trace: bool = False, trace_len=None):
    """Top-k PPR per source: (scores (B, k) f32, vertex ids (B, k) int32),
    the serving layer's PPR query shape; ``return_stats`` appends the
    engine's stats (all pulls)."""
    out = ppr_batched(csr, sources, damping=damping, iters=iters,
                      return_stats=return_stats, trace=trace,
                      trace_len=trace_len)
    x, stats = out if return_stats else (out, None)
    vals, idx = torch.topk(x, k)
    if return_stats:
        return vals, idx.to(torch.int32), stats
    return vals, idx.to(torch.int32)


def pagerank_distributed(g, att, mesh, *, damping: float = 0.85,
                         iters: int = 20, return_stats: bool = False,
                         axis=None):
    """This rank's (per_shard,) f32 PageRank rows; ``att`` owns both the
    vertex data and ``g``'s source rows.  Degrees come from a remote
    scatter-add of the rank's own edges; the dangling mass is one
    all-reduce a level.

    Padding slots (past a shard's span) stay 0.  The reference updates
    them like vertices, so under a rule with padding they collect mass as
    dangling sinks and the vector leaves the local ``pagerank`` (ROADMAP
    §C.5); the port holds the local result."""
    mesh = mesh.over(axis)
    n, per, dev = att.n_global, att.per_shard, mesh.device
    shard = local_shard(g, mesh)
    ones = torch.where(shard.src >= 0, 1.0, 0.0)
    deg = offload.remote_scatter_add(
        torch.zeros(per, dtype=torch.float32, device=dev), shard.src, ones,
        att, mesh, capacity=shard.edges_per_shard)
    inv_deg = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0), 0.0)
    _, real = att.resident(mesh.rank, dev)

    def msg_fn(state, frontier):
        return state["x"] * inv_deg

    def update_fn(state, acc, frontier, it):
        x = state["x"]
        dangling = offload.hierarchical_psum(
            torch.where(deg > 0, 0.0, x).sum(), mesh)
        x = (1 - damping) / n + damping * (acc + dangling / n)
        return {"x": torch.where(real, x, 0.0)}, frontier

    prog = engine.VertexProgram(edge_op="copy", combine="add",
                                msg_fn=msg_fn, update_fn=update_fn)
    x0 = torch.where(real, 1.0 / n, 0.0).to(torch.float32)
    frontier0 = torch.ones(per, dtype=torch.int32, device=dev)
    out = engine.run_distributed(g, att, mesh, prog, {"x": x0}, frontier0,
                                 max_iters=iters, mode="push",
                                 return_stats=return_stats)
    if return_stats:
        state, stats = out
        return state["x"], stats
    return out["x"]
