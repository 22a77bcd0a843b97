"""Connected components via min-label propagation, on the frontier engine.

Every vertex starts labeled with its own id; active vertices broadcast their
label and destinations keep the minimum — the (min, copy) instance of the
engine's semiring.  A vertex whose label shrinks re-enters the frontier, so
work decays to the slowly-converging boundary vertices, where the
direction-optimizing switch pays off (dense first sweeps, sparse tail).
Components are defined on the *undirected* structure; by default the input
is symmetrized (A + A^T pattern).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import engine
from ..graph import CSR

__all__ = ["connected_components", "cc_program", "symmetrize"]

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
