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
run and on both devices.

Distributed, :func:`label_propagation_distributed` takes the transposed
edge list sharded by vote-source owner and pushes each sweep through the
engine:
(voter, label, weight) triples are owner-routed raw and reduced by the
remote weighted mode at the voter's owner (``segment_mode`` on the card).
Under a contiguous rule the votes of a run arrive in ascending source
order, as the local dense step adds them, so the labels equal the local
LPA's.

Distributed Louvain (:func:`multilevel_distributed`) runs the local
level pipeline with every stage on the ranks.  Each rank holds its level
graph's edges by source owner; the level's labels are replicated (one
``all_gather`` of S x per_shard x 4 bytes a sweep), so label reads are
local gathers and the community aggregates are local in-order sums over
the replicated vertex degrees.  The candidate vote is the voter's local
``segment_weighted_mode``; the in-side sums of the gain gate reach each
vertex's owner through one ordered routed sum
(``offload.remote_scatter_add(ordered=True)``), in ascending source order
under a contiguous rule, as the local gate adds them.  So on integer
weights (exact in f32 whatever the order) the partitions equal the local
``multilevel``'s; on float weights the only order left free is the
totals' (the edge weight total and modularity's intra weight are summed
per rank, then across ranks).  :func:`contract_distributed` pre-reduces
each rank's coarse edges, routes each to its new owner under the coarse
block rule and merges them there, summing as the reference's contraction
does (float64 per sender, then float64 over the senders in rank order).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import engine, offload
from ..dgas import block_rule
from ..graph import CSR, contract
from .distgraph import GraphShard, local_shard

__all__ = ["label_propagation", "lpa_program", "louvain_candidate_program",
           "modularity", "louvain_local_moves", "multilevel",
           "partition_equal", "label_propagation_distributed",
           "modularity_distributed", "contract_distributed",
           "multilevel_distributed"]


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


def label_propagation_distributed(g_t, att, mesh, *, iters: int = 10,
                                  return_stats: bool = False, axis=None):
    """Distributed LPA: this rank's (per_shard,) int32 labels under ``att``.
    ``g_t`` holds the *transposed* edge set sharded by vote-source owner
    (``shard_graph(csr.transpose(), S, row_att=att)``, or its rank's
    shard), as the reference shards it; under a contiguous rule (its
    default is ``block_rule(n, S)``) the labels equal the local LPA's.
    Each sweep pushes at full capacity (the frontier is all-ones, so a
    compacted push would always fall back).  ``return_stats`` adds the
    engine's stats."""
    mesh = mesh.over(axis)
    dev = mesh.device
    gid, real = att.resident(mesh.rank, dev)
    state0 = {"label": torch.where(real, gid, 0).to(torch.int32)}
    frontier0 = torch.ones(att.per_shard, dtype=torch.int32, device=dev)
    out = engine.run_distributed(g_t, att, mesh, lpa_program(), state0,
                                 frontier0, max_iters=iters, mode="push",
                                 push_edge_capacity=0,
                                 return_stats=return_stats)
    if return_stats:
        state, stats = out
        return state["label"], stats
    return out["label"]


@dataclasses.dataclass
class _Level:
    """One rank's view of a distributed level graph: its live edges (the
    shard's src, dst, val without padding, in CSR order), their local
    source slots, the replicated vertex degrees (f32 for the gain gate,
    f64 for modularity) and the totals.  ``n_rows`` / ``device`` let
    ``engine.run_multilevel`` drive it like a CSR."""

    shard: GraphShard
    att: object
    mesh: object
    src: torch.Tensor
    dst: torch.Tensor
    val: torch.Tensor
    lsrc: torch.Tensor
    cap: int
    kout: torch.Tensor
    kin: torch.Tensor
    kout64: torch.Tensor
    kin64: torch.Tensor
    m64: torch.Tensor
    w_tot: torch.Tensor

    @property
    def n_rows(self) -> int:
        return self.att.n_global

    @property
    def device(self) -> torch.device:
        return self.mesh.device


def _replicate(own: torch.Tensor, att, mesh) -> torch.Tensor:
    """The (n,) global array from every rank's (per_shard,) rows: one
    ``all_gather`` (each rank receives S x per_shard elements)."""
    g = mesh.all_gather(own).reshape(-1)
    gid = torch.arange(att.n_global, device=own.device)
    return g[att.flat_slot(gid).long()]


def _in_sums(lv: _Level, *planes) -> list:
    """Per owned vertex, each plane's values over the in-edges, added in
    arrival order (ascending source under a contiguous rule): one ordered
    routed sum per plane."""
    return [offload.remote_scatter_add(
        torch.zeros(lv.att.per_shard, dtype=w.dtype, device=lv.device),
        lv.dst, w, lv.att, lv.mesh, capacity=lv.cap, ordered=True)
        for w in planes]


def _level(g, att, mesh) -> _Level:
    """The level's invariants on this rank: its live edges, a routing
    capacity that no (rank, owner) pair exceeds (one all-reduce), the
    vertex degrees summed in CSR order and replicated, and the totals."""
    shard = local_shard(g, mesh)
    live = shard.src >= 0
    src, dst = shard.src[live].long(), shard.dst[live].long()
    val = shard.val[live]
    S, per = mesh.size, att.per_shard
    lsrc = att.local(src).long()
    peer = torch.bincount(att.owner(dst).long(), minlength=S).max() \
        if src.numel() else torch.zeros((), dtype=torch.int64,
                                        device=mesh.device)
    cap = max(1, int(mesh.all_reduce(peer.reshape(1), "max")[0]))
    lv = _Level(shard, att, mesh, src, dst, val, lsrc, cap, *([None] * 6))
    v64 = val.to(torch.float64)
    kin, kin64 = _in_sums(lv, val, v64)
    lv.kout = _replicate(offload.run_sum(lsrc, val, per), att, mesh)
    lv.kout64 = _replicate(offload.run_sum(lsrc, v64, per), att, mesh)
    lv.kin, lv.kin64 = (_replicate(k, att, mesh) for k in (kin, kin64))
    lv.m64 = mesh.all_reduce(offload.tree_sum(v64).reshape(1), "sum")[0]
    lv.w_tot = lv.m64.to(torch.float32)
    return lv


def _modularity_of(lv: _Level, lab: torch.Tensor) -> torch.Tensor:
    """Q of the replicated (n,) labels ``lab`` on level ``lv`` (0-d f32,
    the same on every rank): the community degrees are local in-order
    float64 sums of the replicated degrees, as the local
    :func:`modularity` takes them; the intra weight is one all-reduce of
    the ranks' float64 partial sums."""
    n = lv.n_rows
    lab = lab.to(torch.int32)
    same = lab[lv.src] == lab[lv.dst]
    e_part = offload.tree_sum(torch.where(same, lv.val.to(torch.float64),
                                          0.0))
    e_in = lv.mesh.all_reduce(e_part.reshape(1), "sum")[0] / lv.m64
    c_out = offload.segment_sum_ordered(lv.kout64, lab, n)
    c_in = offload.segment_sum_ordered(lv.kin64, lab, n)
    q = e_in - offload.tree_sum(c_out * c_in) / (lv.m64 * lv.m64)
    return q.to(torch.float32)


def modularity_distributed(g, att, mesh, labels, *, axis=None
                           ) -> torch.Tensor:
    """Distributed Newman modularity (directed form) on one rank of
    ``mesh``: ``g`` is edge-sharded by source owner under ``att`` (the
    stacked graph or this rank's shard) and ``labels`` this rank's
    (per_shard,) rows of the labeling.  Returns Q (0-d f32), the same on
    every rank.  The labels and the vertex degrees are replicated (one
    ``all_gather`` each; the in-degrees take one ordered routed sum), the
    intra-community weight is one all-reduce."""
    mesh = mesh.over(axis)
    lv = _level(g, att, mesh)
    lab = _replicate(torch.as_tensor(labels, device=mesh.device).to(
        torch.int32), att, mesh)
    return _modularity_of(lv, lab)


def _sweep_distributed(lv: _Level, lab: torch.Tensor,
                       down_only: bool) -> torch.Tensor:
    """One gain-gated local-move sweep on the ranks: the replicated (n,)
    labels in, the replicated (n,) labels out.  The candidate is the
    voter's local weighted mode over its out-edges; the candidates are
    replicated (one ``all_gather``); the in-side sums of the gate (intra
    weight, weight from the candidate's community) reach each vertex's
    owner in one ordered routed sum each; the gate runs on the owned rows,
    and the new rows are replicated again."""
    att, mesh, per = lv.att, lv.mesh, lv.att.per_shard
    ns = lv.src != lv.dst
    lab_src, lab_dst = lab[lv.src], lab[lv.dst]
    cand_w, cand_l = offload.segment_weighted_mode(
        torch.where(ns, lv.lsrc, -1), lab_dst, lv.val, per)
    same = ns & (lab_src == lab_dst)
    w_same = torch.where(same, lv.val, 0.0)
    w_out_same = offload.run_sum(lv.lsrc, w_same, per)
    cand = _replicate(cand_l, att, mesh)
    bl = torch.where(cand >= 0, cand, -2)
    to_b = ns & (lab_src == bl[lv.dst])
    w_in_same, w_in_b = _in_sums(lv, w_same,
                                 torch.where(to_b, lv.val, 0.0))
    s_lab, order = torch.sort(lab, stable=True)
    out_c = offload.run_sum(s_lab, lv.kout[order], lv.n_rows)
    in_c = offload.run_sum(s_lab, lv.kin[order], lv.n_rows)
    gid, real = att.resident(mesh.rank, lv.device)
    safe = torch.where(real, gid, 0).long()
    own = _gate_moves(lab[safe], cand_w, cand_l, w_in_b, w_out_same,
                      w_in_same, lv.kout[safe], lv.kin[safe], out_c, in_c,
                      lv.w_tot, down_only)
    return _replicate(torch.where(real, own, 0), att, mesh)


def _contract(lv: _Level, lab: torch.Tensor, counter=None):
    """:func:`contract_distributed` on the replicated (n,) labels."""
    mesh, S, dev = lv.mesh, lv.mesh.size, lv.device
    dense, n_c_dev = offload.compact_labels(lab.to(torch.int32))
    n_c = int(n_c_dev)
    catt = block_rule(n_c, S)
    # sender-side pre-reduction: one float64 sum per coarse pair, in edge
    # order (the reference's bincount), rounded once to f32
    key = dense[lv.src].long() * n_c + dense[lv.dst].long()
    skey, order = torch.sort(key, stable=True)
    if skey.numel():
        start, run_id = offload.run_starts(skey)
        w = offload.run_sum(run_id, lv.val[order].to(torch.float64),
                            int(run_id[-1]) + 1).to(torch.float32)
        ukey = skey[start]
    else:
        w, ukey = lv.val[:0], skey
    usrc, udst = ukey // n_c, ukey % n_c
    owner = catt.owner(usrc)
    peer = torch.bincount(owner, minlength=S)
    cnt = torch.stack([(owner != mesh.rank).sum(), peer.max() if
                       ukey.numel() else peer.new_zeros(())])
    n_routed = int(mesh.all_reduce(cnt[:1], "sum")[0])
    cap = max(1, int(mesh.all_reduce(cnt[1:], "max")[0]))
    if counter is not None:
        counter.contract_level(n_routed)
    (rs, rd, rw), ok, _, _ = offload._route(
        (usrc.to(torch.int32), udst.to(torch.int32), w),
        owner.to(torch.int32), mesh, cap)
    # the owner merges the senders' pairs: arrivals by source rank, so a
    # pair's sum adds the senders in rank order (the reference's
    # sum_duplicates over the concatenated parts)
    rkey = torch.where(ok, rs.long() * n_c + rd.long(), -1)
    rkey, order = torch.sort(rkey, stable=True)
    rw = rw[order]
    keep = rkey >= 0
    rkey, rw = rkey[keep], rw[keep]
    if rkey.numel():
        start, run_id = offload.run_starts(rkey)
        cw = offload.run_sum(run_id, rw.to(torch.float64),
                             int(run_id[-1]) + 1).to(torch.float32)
        ckey = rkey[start]
    else:
        cw, ckey = rw, rkey
    m = max(1, int(mesh.all_reduce(torch.tensor(
        [ckey.numel()], device=dev), "max")[0]))
    pad = [torch.full((m,), -1, dtype=torch.int32, device=dev),
           torch.full((m,), -1, dtype=torch.int32, device=dev),
           torch.zeros(m, dtype=torch.float32, device=dev)]
    k = ckey.numel()
    pad[0][:k], pad[1][:k], pad[2][:k] = ckey // n_c, ckey % n_c, cw
    coarse = GraphShard(*pad, n_c, S, mesh.rank)
    return coarse, catt, dense, n_routed


def contract_distributed(g, att, labels, mesh, *, counter=None, axis=None):
    """Contract an edge-sharded graph along a labeling, on one rank of
    ``mesh``, routing each surviving coarse edge to its new owner.

    ``g`` is sharded by source owner under ``att``; ``labels`` this rank's
    (per_shard,) rows.  The dense renumbering (``offload.compact_labels``)
    needs the global labels: they reach every rank through one
    ``all_gather`` (each rank receives S x per_shard x 4 bytes), and every
    rank renumbers alike.  Each rank relabels its edges ((u, v, w) ->
    (label[u], label[v], w)), pre-reduces duplicate coarse pairs (float64,
    in edge order), and routes every pre-reduced edge to the owner of its
    coarse source under ``block_rule(n_c, S)`` (one ``_route``: 4 + 4 + 4
    + 1 bytes a slot at the largest (rank, owner) count); the edges whose
    owner changes are the reference's ``n_routed``, charged to
    ``counter.contract_level``.  The owner merges its arrivals into its
    coarse shard, in CSR order.

    Returns ``(coarse_shard, coarse_att, renumber, n_routed)``: this
    rank's :class:`GraphShard` of the coarse graph, the coarse block rule,
    the (n,) int32 map from vertex to coarse vertex (the same on every
    rank) and the global count of routed edges."""
    mesh = mesh.over(axis)
    shard = local_shard(g, mesh)
    live = shard.src >= 0
    src, dst = shard.src[live].long(), shard.dst[live].long()
    lv = _Level(shard, att, mesh, src, dst, shard.val[live], None, 0,
                *([None] * 6))
    lab = _replicate(torch.as_tensor(labels, device=mesh.device).to(
        torch.int32), att, mesh)
    return _contract(lv, lab, counter)


def multilevel_distributed(g, att, mesh, *, axis=None, max_levels: int = 10,
                           max_sweeps: int = 30, tol: float = 1e-4,
                           sweep_tol: float = 1e-6, counter=None):
    """Distributed multi-level Louvain on one rank of ``mesh``: the local
    :func:`multilevel`'s level pipeline (``engine.run_multilevel``, the
    same hill climb, gate and stall rules) with every stage on the ranks.

    ``g`` is the level-0 graph edge-sharded by source owner under ``att``
    (the stacked graph or this rank's shard; a contiguous rule gives the
    local gate's summation order).  Each level's sweeps run on the rank's
    shard, the level is scored as the local run scores it (modularity of
    the projected labels on the level-0 graph), and an accepted level is
    contracted with :func:`contract_distributed` (charging ``counter``);
    the coarse levels are block-ruled.

    Returns ``(labels, scores)``: the (n,) int32 community labels of the
    input graph, the same on every rank, and the accepted levels' scores.
    On integer weights the partition equals the local ``multilevel``'s."""
    mesh = mesh.over(axis)
    top = _level(g, att, mesh)
    maps = []

    def level_fn(lv, level):
        lab0 = torch.arange(lv.n_rows, dtype=torch.int32, device=lv.device)
        return _hill_climb(
            lambda lab, s: _sweep_distributed(lv, lab, s % 2 == 0),
            lambda lab: _modularity_of(lv, lab), lab0,
            float(_modularity_of(lv, lab0)), max_sweeps, sweep_tol)[0]

    def score_fn(lv, assign):
        return _modularity_of(top, engine.Hierarchy(tuple(maps)).project(
            assign))

    def contract_fn(lv, assign):
        coarse, catt, renumber, _ = _contract(lv, assign, counter)
        maps.append(renumber)
        return _level(coarse, catt, mesh), renumber

    labels, _, scores = engine.run_multilevel(
        top, level_fn, contract_fn, score_fn, max_levels=max_levels,
        tol=tol)
    return labels, scores


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
