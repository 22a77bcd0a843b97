"""Connected components via min-label propagation, on the frontier engine.

Every vertex starts labeled with its own id; active vertices broadcast their
label and destinations keep the minimum — the (min, copy) instance of the
engine's semiring.  A vertex whose label shrinks re-enters the frontier, so
work decays to the slowly-converging boundary vertices, where the
direction-optimizing switch pays off (dense first sweeps, sparse tail).
Components are defined on the *undirected* structure; by default the input
is symmetrized (A + A^T pattern).  Distributed, the label pushes are
remote atomic *min* ops at the destination owner, and the caller hands in
an already symmetric sharded graph.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import engine
from ..graph import CSR

__all__ = ["connected_components", "cc_program", "symmetrize",
           "connected_components_distributed"]

_PAD_LABEL = 2 ** 30


def symmetrize(csr: CSR) -> CSR:
    """A + A^T pattern (unweighted), on the CSR's device."""
    rows, cols = csr.row_ids(), csr.indices
    return CSR.from_coo(torch.cat([rows, cols]), torch.cat([cols, rows]),
                        None, csr.n_rows, csr.n_cols, sum_duplicates=True,
                        device=csr.device)


def cc_program() -> engine.VertexProgram:
    def msg_fn(state, frontier):
        return torch.where(frontier > 0, state["label"], _PAD_LABEL)

    def update_fn(state, acc, frontier, it):
        label = state["label"]
        changed = acc < label
        return ({"label": torch.minimum(label, acc)},
                changed.to(torch.int32))

    return engine.VertexProgram(edge_op="copy", combine="min",
                                msg_fn=msg_fn, update_fn=update_fn,
                                identity=_PAD_LABEL)


def connected_components(csr: CSR, *, max_iters: Optional[int] = None,
                         symmetrize_input: bool = True,
                         mode: str = "auto", return_stats: bool = False):
    """Returns (n,) int32 — each vertex's component id (its min member id).
    ``return_stats`` adds the engine's {'iters', 'pushes', 'pulls'}."""
    g = symmetrize(csr) if symmetrize_input else csr
    n = g.n_rows
    max_iters = max_iters if max_iters is not None else n
    state0 = {"label": torch.arange(n, dtype=torch.int32, device=g.device)}
    frontier0 = torch.ones(n, dtype=torch.int32, device=g.device)
    out = engine.run(g, cc_program(), state0, frontier0,
                     max_iters=max_iters, mode=mode,
                     return_stats=return_stats)
    if return_stats:
        state, stats = out
        return state["label"], stats
    return out["label"]


def connected_components_distributed(g, att, mesh, *, max_iters: int = 256,
                                     placement: str = "sync",
                                     sync_interval: Optional[int] = None,
                                     return_stats: bool = False, axis=None):
    """This rank's (per_shard,) int32 labels under ``att``.  ``g`` must
    hold the symmetric edge set (shard ``symmetrize(csr)``).  The
    min-label program is monotone, so placement='async' reaches the same
    labels.  Every slot starts labelled with its global id
    (``att.to_global``), padding slots too, as the reference starts them;
    they have no edges.  ``return_stats`` adds the engine's stats."""
    mesh = mesh.over(axis)
    rank = torch.full((att.per_shard,), mesh.rank, device=mesh.device)
    label0 = att.to_global(rank, torch.arange(att.per_shard,
                                              device=mesh.device))
    frontier0 = torch.ones(att.per_shard, dtype=torch.int32,
                           device=mesh.device)
    out = engine.run_distributed(g, att, mesh, cc_program(),
                                 {"label": label0.to(torch.int32)}, frontier0,
                                 max_iters=max_iters, mode="push",
                                 placement=placement,
                                 sync_interval=sync_interval,
                                 return_stats=return_stats)
    if return_stats:
        state, stats = out
        return state["label"], stats
    return out["label"]
