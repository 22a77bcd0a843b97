"""Community detection (the paper's "Louvain Community"), local placement.

The local-move sweep is weighted label propagation: every vertex adopts the
label with maximal incident edge weight.  The sweep is an engine program:
the per-vertex weighted vote is the engine's ``combine='argmax_weighted'``
structured combine (:func:`offload.segment_weighted_mode`, the
``segment_mode`` kernel on the card), so this module holds only the
message/update rules.  Votes come from a vertex's *out*-neighbours and the
engine combines over in-edges, so the program runs on the transposed
adjacency.

The sweeps compose into **multi-level Louvain**: the engine's argmax
combine picks each vertex's heaviest neighbour community as a *candidate*
(:func:`louvain_candidate_program`), and a vectorized gain gate accepts
the move only when the exact directed-modularity delta is positive (and,
on even sweeps, the target label is smaller, so synchronous moves cannot
swap-cycle).  :func:`multilevel` runs gated sweeps until modularity
stalls, contracts the communities (`graph.contract`) and repeats on
`engine.run_multilevel`'s level pipeline.

Every sum that decides a move is taken in a fixed order, the same on the
CPU and the card: per-vertex and per-community sums in stream order
(:func:`offload.run_sum` over the CSR's row order, its cached
destination-sorted stream or a stable sort of the labels), totals by
:func:`offload.tree_sum`.  A sweep therefore gives the same bits in every
run and on both devices.  The distributed sweeps wait for the distributed
placement.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import engine, offload
from ..graph import CSR, contract

__all__ = ["label_propagation", "lpa_program", "louvain_candidate_program",
           "modularity", "louvain_local_moves", "multilevel",
           "partition_equal"]


def partition_equal(a, b) -> bool:
    """True iff two labelings induce the same partition (a bijective label
    correspondence)."""
    m1, m2 = {}, {}
    for x, y in zip(_host(a).tolist(), _host(b).tolist()):
        if m1.setdefault(x, y) != y or m2.setdefault(y, x) != x:
            return False
    return True


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def lpa_program() -> engine.VertexProgram:
    """Weighted label propagation as an argmax-combine engine program.

    Messages are current labels; the edge value is the vote weight; the
    combine returns (winning label's total weight, winning label) with ties
    toward the smaller label.  Vertices with no positive incident vote keep
    their label.  Every vertex stays active every sweep, so the engine runs
    exactly ``max_iters`` sweeps.
    """

    def msg_fn(state, frontier):
        return torch.where(frontier > 0, state["label"], -1)

    def update_fn(state, acc, frontier, it):
        best_w, best_l = acc
        label = torch.where(best_w > 0, best_l, state["label"])
        return {"label": label}, torch.ones_like(frontier)

    return engine.VertexProgram(edge_op="mul", combine="argmax_weighted",
                                msg_fn=msg_fn, update_fn=update_fn)


def label_propagation(csr: CSR, *, iters: int = 10,
                      mode: str = "pull") -> torch.Tensor:
    """Returns (n,) int32 community labels on the CSR's device.

    Defaults to mode='pull': the frontier is all-ones every sweep, so the
    push machinery would be dead weight under 'auto'.
    """
    n, dev = csr.n_rows, csr.device
    state0 = {"label": torch.arange(n, dtype=torch.int32, device=dev)}
    frontier0 = torch.ones(n, dtype=torch.int32, device=dev)
    # votes flow out-neighbour -> voter: run the program over A^T's edges
    state = engine.run(csr.transpose(), lpa_program(), state0, frontier0,
                       max_iters=iters, mode=mode)
    return state["label"]


def _values(csr: CSR) -> torch.Tensor:
    return csr.values if csr.values is not None else torch.ones(
        csr.nnz, dtype=torch.float32, device=csr.device)


def _out_sum(csr: CSR, w: torch.Tensor) -> torch.Tensor:
    """Per source row, ``w`` (in CSR order) summed in CSR order."""
    return offload.run_sum(csr.row_ids(), w, csr.n_rows)


def _in_sum(csr: CSR, w: torch.Tensor) -> torch.Tensor:
    """Per destination, ``w`` (in CSR order) summed in CSR order, through
    the CSR's cached destination-sorted stream."""
    _, dst, order = engine._dst_sorted(csr)
    return offload.run_sum(dst, w[order], csr.n_cols)


def modularity(csr: CSR, labels: torch.Tensor) -> torch.Tensor:
    """Newman modularity Q of a labeling (directed form), a 0-d f32 tensor
    on the CSR's device.

    Its sums run in float64, in a fixed order (the same bits on every
    device): a community's degree is the in-order sum of up to ~10^5 vertex
    degrees at RMAT-20, where f32 would move Q by ~1e-5 and make a level's
    score differ from the same partition's Q on the fine graph.  Q is
    rounded to f32 once, as the reference returns it."""
    vals = _values(csr).to(torch.float64)
    rows, cols = csr.index64()
    lab = labels.to(torch.int32)
    m = offload.tree_sum(vals)
    same = offload.dma_gather(lab, rows) == offload.dma_gather(lab, cols)
    e_in = offload.tree_sum(torch.where(same, vals, 0.0)) / m
    c_out = offload.segment_sum_ordered(_out_sum(csr, vals), lab, csr.n_rows)
    c_in = offload.segment_sum_ordered(_in_sum(csr, vals), lab, csr.n_rows)
    q = e_in - offload.tree_sum(c_out * c_in) / (m * m)
    return q.to(torch.float32)


# ---------------------------------------------------------------------------
# Multi-level Louvain (gain-gated local moves + contraction on the pipeline)
# ---------------------------------------------------------------------------

def louvain_candidate_program() -> engine.VertexProgram:
    """Record (not adopt) each vertex's heaviest neighbour-community
    candidate: the update stores the (weight, label) winner and drains the
    frontier, and the gain gate outside the engine decides the move.  One
    recording pass per sweep (``max_iters=1``)."""

    def msg_fn(state, frontier):
        return torch.where(frontier > 0, state["label"], -1)

    def update_fn(state, acc, frontier, it):
        cand_w, cand_l = acc
        return ({"label": state["label"], "cand_w": cand_w,
                 "cand_l": cand_l}, torch.zeros_like(frontier))

    return engine.VertexProgram(edge_op="mul", combine="argmax_weighted",
                                msg_fn=msg_fn, update_fn=update_fn)


def _vote_transpose(csr: CSR) -> CSR:
    """A^T of the self-loop-free voting graph, on the CSR's device (once per
    level).  Self-loops stay in the level graph (they carry contracted
    intra-community weight and feed modularity and degrees) but must not
    vote: a supernode's self-vote is the 'stay' option, whose gain is zero
    by definition in the gate."""
    rows, cols = csr.index64()
    keep = rows != cols
    return CSR.from_coo(cols[keep], rows[keep], _values(csr)[keep],
                        csr.n_rows, csr.n_cols, device=csr.device)


def _gate_moves(lab, cand_w, cand_l, w_in_b, w_out_same, w_in_same,
                kout, kin, out_c, in_c, w_tot, down_only: bool):
    """The gain-gate tail (see :func:`_gain_gate` for the math)."""
    lab_l = lab.long()
    w_to_b = torch.where(cand_l >= 0, cand_w, 0.0)
    b = torch.where(cand_l >= 0, cand_l, lab)
    b_l = b.long()
    d_e = (w_to_b + w_in_b) - (w_out_same + w_in_same)
    d_pen = (kout * (in_c[b_l] - in_c[lab_l])
             + kin * (out_c[b_l] - out_c[lab_l])
             + 2.0 * kout * kin)
    dq = d_e / w_tot - d_pen / (w_tot * w_tot)
    move = (b != lab) & (dq > 0)
    if down_only:
        move &= b < lab
    return torch.where(move, b, lab)


def _gain_gate(csr: CSR, lab: torch.Tensor, cand_w: torch.Tensor,
               cand_l: torch.Tensor, kout: torch.Tensor, kin: torch.Tensor,
               w_tot, down_only: bool) -> torch.Tensor:
    """Accept candidate moves whose exact directed-modularity delta is > 0.

    For v moving from community A to B the delta of
    ``Q = sum_c e_c/W - sum_c out_c*in_c/W^2`` is::

        d_e   = [w(v->B) + w(B->v)] - [w(v->A\\v) + w(A\\v->v)]
        d_pen = kout_v*(in_B - in_A) + kin_v*(out_B - out_A) + 2*kout_v*kin_v
        dQ    = d_e/W - d_pen/W^2

    (self-loops cancel; A's aggregates include v).  w(v->B) is the
    candidate's vote weight from the engine combine; the other terms are
    per-vertex and per-community sums in stream order.  ``down_only``
    restricts moves to B < A: under a strictly decreasing label order
    synchronous moves cannot swap-cycle.
    """
    n = csr.n_rows
    rows, cols = csr.index64()
    vals = _values(csr)
    ns = rows != cols
    lab_r, lab_c = lab[rows], lab[cols]
    same = ns & (lab_r == lab_c)
    w_same = torch.where(same, vals, 0.0)
    w_out_same = _out_sum(csr, w_same)
    w_in_same = _in_sum(csr, w_same)
    bl_safe = torch.where(cand_l >= 0, cand_l, -2)
    to_b = ns & (lab_r == bl_safe[cols])
    w_in_b = _in_sum(csr, torch.where(to_b, vals, 0.0))
    s_lab, order = torch.sort(lab, stable=True)
    out_c = offload.run_sum(s_lab, kout[order], n)
    in_c = offload.run_sum(s_lab, kin[order], n)
    return _gate_moves(lab, cand_w, cand_l, w_in_b, w_out_same, w_in_same,
                       kout, kin, out_c, in_c, w_tot, down_only)


def _sweep(vote_t: CSR, csr: CSR, lab, kout, kin, w_tot,
           down_only: bool) -> torch.Tensor:
    """One local-move sweep: the candidate pass on the voting transpose,
    then the gain gate."""
    n, dev = csr.n_rows, csr.device
    state0 = {"label": lab,
              "cand_w": torch.zeros(n, dtype=torch.float32, device=dev),
              "cand_l": torch.full((n,), -1, dtype=torch.int32, device=dev)}
    st = engine.run(vote_t, louvain_candidate_program(), state0,
                    torch.ones(n, dtype=torch.int32, device=dev),
                    max_iters=1, mode="pull")
    return _gain_gate(csr, lab, st["cand_w"], st["cand_l"], kout, kin,
                      w_tot, down_only)


def _hill_climb(step_fn, score_fn, x0, q0, max_steps: int, tol: float):
    """Greedy improving-only loop: ``step_fn(x, s)`` proposes,
    ``score_fn(cand)`` measures (read to the host: the accept test is the
    control flow), a proposal is kept only if it improves by more than
    ``tol``, and the climb stops once two proposals in a row fail (the
    sweeps alternate down-only / free parity, so both must stall).  Returns
    ``(x, best_score)``."""
    x, q_best, stale = x0, q0, 0
    for s in range(max_steps):
        cand = step_fn(x, s)
        q = float(score_fn(cand))
        if math.isfinite(q) and q > q_best + tol:
            x, q_best, stale = cand, q, 0
        else:
            stale += 1
            if stale >= 2:
                break
    return x, q_best


def louvain_local_moves(csr: CSR, *, max_sweeps: int = 30,
                        sweep_tol: float = 1e-6):
    """Louvain phase 1 on one (coarse) graph: gain-gated local moves until
    modularity stalls.

    Each sweep runs the engine candidate program (one argmax-combine pass
    on the voting transpose) and the :func:`_gain_gate` — even sweeps
    down-only, odd sweeps free; the :func:`_hill_climb` keeps a sweep only
    if it improves :func:`modularity` by more than ``sweep_tol``.  Returns
    ``(labels, q)``.
    """
    vote_t = _vote_transpose(csr)
    vals = _values(csr)
    kout = _out_sum(csr, vals)
    kin = _in_sum(csr, vals)
    w_tot = offload.tree_sum(vals)
    lab0 = torch.arange(csr.n_rows, dtype=torch.int32, device=csr.device)
    return _hill_climb(
        lambda lab, s: _sweep(vote_t, csr, lab, kout, kin, w_tot,
                              s % 2 == 0),
        lambda lab: modularity(csr, lab),
        lab0, float(modularity(csr, lab0)), max_sweeps, sweep_tol)


def multilevel(csr: CSR, *, max_levels: int = 10, max_sweeps: int = 30,
               tol: float = 1e-4, sweep_tol: float = 1e-6):
    """Multi-level Louvain: gain-gated engine sweeps + community contraction
    until modularity stalls.

    Each level runs :func:`louvain_local_moves` on the current (coarse)
    graph and contracts the communities with `graph.contract`;
    `engine.run_multilevel` owns the loop and the stall criterion, so the
    returned scores increase strictly.  A level's score is the modularity
    of its assignment projected to the input graph, taken on the input
    graph — the reference's score, which it takes on the coarse graph
    (equal in exact arithmetic, as contraction leaves Q invariant), without
    contraction's rounding: the coarse weights are in-order f32 sums (the
    reference's bits), and at RMAT-20 a community's run of ~10^6 intra
    edges moves the coarse graph's Q by ~1e-5.

    Returns ``(labels, scores)``: the (n,) int32 community labels on the
    original graph and the accepted levels' modularity trace.
    """
    maps = []

    def level_fn(g, level):
        return louvain_local_moves(g, max_sweeps=max_sweeps,
                                   sweep_tol=sweep_tol)[0]

    def score_fn(g, assign):
        return modularity(csr, engine.Hierarchy(tuple(maps)).project(assign))

    def contract_fn(g, assign):
        coarse, renumber = contract(g, assign)
        maps.append(renumber)
        return coarse, renumber

    labels, _, scores = engine.run_multilevel(
        csr, level_fn, contract_fn, score_fn, max_levels=max_levels, tol=tol)
    return labels, scores
