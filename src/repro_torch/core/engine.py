"""Direction-optimizing vertex-program execution engine (torch).

Counterpart of ``repro.core.engine`` at one point of its grid: scalar lanes
(one traversal) on the local placement (one device).  Every frontier
algorithm of this package is the same loop: per-vertex *messages* flow along
edges and are combined at the destination, then a per-vertex *update*
produces the next state and the next frontier::

    msg  = msg_fn(state, frontier)            # (n,) — identity on inactive
    acc[v] = combine_{(u,v) in E} edge_op(msg[u], w_uv)
    state, frontier = update_fn(state, acc, frontier, it)

with ``edge_op`` in {mul, add, copy} and ``combine`` in {add, min, max}.
Frontier masking is folded into ``msg_fn`` (inactive vertices emit the
combine identity), which is what makes push and pull produce the same acc.

Direction optimization: the **sparse / push** step expands only the active
vertices' adjacency rows (work ∝ their edges); the **dense / pull** step is
one edge-parallel pass.  'auto' pushes while the active count fits the push
capacity (n/32 by default) and pulls otherwise.  With a BBCSR operand of A^T
(:func:`build_pull_operand`) both directions run on the BBCSR kernels
instead: the dense step is SpMV ('add') or SpMSpV with every tile active
('min' / 'max'), the sparse step SpMSpV over the tiles whose column block
holds an active vertex.

The loop (:func:`_core_loop`) is a Python loop that reads one pair of
numbers from the device per level, the active-vertex count and the active
vertices' edge total: the count decides termination and direction, the
total sizes the push step's edge buffer.
"""
# The `single-core` lint rule guards the JAX engine's lax.while_loop /
# shard_map runner seam.  This engine's one stepping loop is the Python loop
# in _core_loop, and its batched and distributed runners belong to later
# slices of the port, so the rule does not apply to this file.
# repro-lint: disable-file=single-core
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from .. import tune as _tune
from .graph import BBCSR, CSR, to_bbcsr

__all__ = ["VertexProgram", "ExecutionCore", "run", "build_pull_operand",
           "tile_active"]

_COMBINE_IDENTITY = {"add": 0.0, "min": float("inf"), "max": float("-inf")}


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    """One frontier algorithm, reduced to its per-edge/per-vertex pieces.

    Attributes:
      edge_op:   how a message meets the edge weight: 'mul' | 'add' | 'copy'.
      combine:   destination-side reduction: 'add' | 'min' | 'max'.
      msg_fn:    (state, frontier) -> (n,) messages; MUST emit `identity` for
                 vertices outside the frontier (that makes push == pull).
      update_fn: (state, acc, frontier, it) -> (state, next_frontier).
      identity:  combine identity (defaults per combine).
    """

    edge_op: str
    combine: str
    msg_fn: Callable[[Any, torch.Tensor], torch.Tensor]
    update_fn: Callable[[Any, torch.Tensor, torch.Tensor, int], tuple]
    identity: Optional[float] = None

    def __post_init__(self):
        if self.edge_op not in ("mul", "add", "copy"):
            raise ValueError(f"unknown edge_op {self.edge_op!r}")
        if self.combine not in _COMBINE_IDENTITY:
            raise ValueError(f"unknown combine {self.combine!r} (this engine "
                             "runs 'add', 'min' and 'max')")

    @property
    def ident(self):
        if self.identity is not None:
            return self.identity
        return _COMBINE_IDENTITY[self.combine]


def _apply_edge(em: torch.Tensor, ev: Optional[torch.Tensor],
                edge_op: str) -> torch.Tensor:
    if edge_op == "mul":
        return em * ev
    if edge_op == "add":
        return em + ev
    return em


def _scatter_combine(dest: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor, combine: str,
                     identity) -> torch.Tensor:
    """Scatter-{add,min,max} into ``dest`` in place, out-of-range indices
    dropped; returns ``dest``."""
    valid = (idx >= 0) & (idx < dest.shape[0])
    safe = torch.where(valid, idx, torch.zeros_like(idx))
    masked = torch.where(valid, vals.to(dest.dtype),
                         dest.new_full((), identity))
    if combine == "add":
        return dest.index_add_(0, safe, masked)
    return dest.scatter_reduce_(0, safe.long(), masked,
                                "amin" if combine == "min" else "amax",
                                include_self=True)


def _acc_init(n: int, prog: VertexProgram, dtype,
              device) -> torch.Tensor:
    return torch.full((n,), prog.ident, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Kernel (BBCSR) operands
# ---------------------------------------------------------------------------

def build_pull_operand(csr: CSR, *, unit_values: bool = False,
                       combine: str = "add", **bb_kwargs) -> BBCSR:
    """BBCSR of A^T — rows are *destinations*, columns are *sources* — so
    ``spmv_dma(bb, msg)`` computes exactly the engine's dense step for an
    'add' program (and ``spmspv_dma`` its sparse step), on the CSR's device.

    The tile geometry defaults to ``combine``'s kernel family in
    :mod:`repro_torch.tune`; explicit ``block_rows=`` / ``block_cols=`` /
    ``tile_nnz=`` kwargs win per key."""
    family = "bbcsr_min" if combine in ("min", "max") else "bbcsr_add"
    params = {k: _tune.resolve(f"kernels.{family}.{k}", bb_kwargs.get(k))
              for k in ("block_rows", "block_cols", "tile_nnz")}
    params.update({k: v for k, v in bb_kwargs.items()
                   if k not in ("block_rows", "block_cols", "tile_nnz")})
    t = csr.transpose()
    if unit_values:
        t = CSR(t.indptr, t.indices, None, t.n_rows, t.n_cols)
    return to_bbcsr(t, **params)


def tile_active(bb: BBCSR, frontier: torch.Tensor) -> torch.Tensor:
    """(n_tiles,) int32 flags: 1 iff the tile's column block holds any active
    source vertex."""
    ncb = bb.n_col_blocks
    f = torch.nn.functional.pad(frontier.to(torch.int32),
                                (0, ncb * bb.block_cols - frontier.shape[0]))
    blk = f.reshape(ncb, bb.block_cols).amax(dim=1)
    return blk[bb.tile_cb.long()]


# ---------------------------------------------------------------------------
# Per-level step primitives (local placement)
# ---------------------------------------------------------------------------

def _gather_rows(indptr, indices, vals, ids, total: int,
                 k: Optional[int] = None):
    """DMA-gather the adjacency rows of ``ids`` (padding id = -1) as one flat
    edge stream, at most ``k`` entries per row (all when None).

    ``total`` is the stream's length (the sum of the rows' capped degrees),
    known to the caller, so nothing here waits on the device.  Returns
    (seg (total,) int64 — the position in ``ids`` each entry came from,
    cols (total,) int64, w (total,) edge values or None).  Rows are
    expanded in ``ids`` order, each in CSR order.
    """
    safe = torch.clamp(ids, min=0).long()
    start = indptr[safe].long()
    deg = indptr[safe + 1].long() - start
    deg = torch.where(ids >= 0, deg, torch.zeros_like(deg))
    if k is not None:
        deg = torch.clamp(deg, max=k)
    seg = torch.repeat_interleave(torch.arange(ids.shape[0], device=ids.device),
                                  deg, output_size=total)
    first = torch.cumsum(deg, 0) - deg
    pos = start[seg] + torch.arange(total, device=ids.device) - first[seg]
    cols = indices[pos].long()
    return seg, cols, None if vals is None else vals[pos]


def _dense_step(rows, cols, vals, msg, n, prog: VertexProgram):
    """Pull direction: one edge-parallel pass over every edge (``rows`` /
    ``cols`` int64)."""
    em = msg[rows]
    ev = _apply_edge(em, vals, prog.edge_op)
    if prog.combine == "add":
        return torch.zeros(n, dtype=msg.dtype, device=msg.device).index_add_(
            0, cols, ev.to(msg.dtype))
    return _scatter_combine(_acc_init(n, prog, msg.dtype, msg.device), cols,
                            ev, prog.combine, prog.ident)


def _sparse_step(indptr, indices, vals, msg, ids, n_edges: int, n,
                 prog: VertexProgram):
    """Push direction: expand only the active vertices' adjacency rows
    (``ids``, their ``n_edges`` edges) and scatter-combine them."""
    seg, cols, w = _gather_rows(indptr, indices, vals, ids, n_edges)
    em = msg[ids.long()][seg]
    contrib = _apply_edge(em, None if w is None else w.to(msg.dtype),
                          prog.edge_op)
    return _scatter_combine(_acc_init(n, prog, msg.dtype, msg.device), cols,
                            contrib, prog.combine, prog.ident)


def _compact(frontier, alive: int, buf, iota):
    """The ascending ids of the ``alive`` active vertices, by cumsum and
    scatter into ``buf`` (capacity >= alive + 1; inactive vertices land in
    the spare slot ``alive``).  No device sync: ``alive`` is already on the
    host."""
    act = frontier != 0
    dest = torch.where(act, torch.cumsum(act, 0) - 1,
                       torch.full_like(iota, alive))
    buf.scatter_(0, dest, iota)
    return buf[:alive]


def _check_kernel_operand(prog: VertexProgram, kernel_bb: BBCSR) -> None:
    """Validate a BBCSR operand against the program's semiring: 'add'
    accumulates val*msg; 'min'/'max' relax msg + w."""
    if prog.combine == "add":
        if prog.edge_op == "add":
            raise ValueError("the 'add'-combine kernels compute val*msg; "
                             "edge_op 'add' has no kernel path")
        if prog.edge_op == "copy":
            v = kernel_bb.vals
            if not bool(((v == 0) | (v == 1)).all()):
                raise ValueError(
                    "edge_op 'copy' needs a unit-valued kernel operand — "
                    "build it with build_pull_operand(csr, unit_values=True)")
    elif prog.combine in ("min", "max"):
        if prog.edge_op != "add":
            raise ValueError("the min/max tile combines relax msg + w: "
                             "edge_op must be 'add'")
        if kernel_bb.tile_cnt is None:
            raise ValueError("min/max tile combines need the BBCSR per-tile "
                             "padding counts — rebuild the operand with "
                             "to_bbcsr")
    else:
        raise ValueError(f"no kernel path for combine {prog.combine!r}")


# ---------------------------------------------------------------------------
# ExecutionCore: THE stepping loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExecutionCore:
    """One lowered (program, placement) pair.  The runner *plans* (builds
    these four callables), the core *steps* (:func:`_core_loop`).

      msg:    (state, frontier) -> messages.
      step:   (msg, frontier, alive, edges) -> (acc, was_push): the level's
              direction decision and the chosen step; ``alive`` and
              ``edges`` are the host-side counts of this level.
      update: (state, acc, frontier, it) -> (state, next_frontier).
      count:  frontier -> (2,) int64 device tensor [active vertices, their
              out-edges].
    """

    msg: Callable
    step: Callable
    update: Callable
    count: Callable


def _core_loop(core: ExecutionCore, state0: Any, frontier0: torch.Tensor, *,
               max_iters: int):
    """Run an :class:`ExecutionCore` to frontier exhaustion (or
    `max_iters`).  The engine's only stepping loop.  Each level reads the
    carried counts to the host once; that one read serves the termination
    test, the direction choice and the push step's buffer size.  Returns
    ``(state, stats)`` with stats = {'iters', 'pushes', 'pulls'} (ints)."""
    state, frontier = state0, frontier0
    it = pushes = 0
    counts = core.count(frontier)
    while it < max_iters:
        alive, edges = counts.tolist()
        if alive == 0:
            break
        msg = core.msg(state, frontier)
        acc, was_push = core.step(msg, frontier, alive, edges)
        state, frontier = core.update(state, acc, frontier, it)
        counts = core.count(frontier)
        it += 1
        pushes += was_push
    return state, {"iters": it, "pushes": pushes, "pulls": it - pushes}


def _direction_step(dense, sparse, mode: str, threshold: int):
    """'pull' always takes the dense step; 'push' / 'auto' take the sparse
    step while the active count fits ``threshold`` (the push capacity) and
    fall back to dense above it."""
    if mode == "pull":
        def step(msg, frontier, alive, edges):
            return dense(msg, frontier), 0
        return step

    def step(msg, frontier, alive, edges):
        if alive <= threshold:
            return sparse(msg, frontier, alive, edges), 1
        return dense(msg, frontier), 0
    return step


# ---------------------------------------------------------------------------
# Local placement
# ---------------------------------------------------------------------------

def _local_core(csr: CSR, prog: VertexProgram, *, mode: str, C: int,
                kernel_bb: Optional[BBCSR]) -> ExecutionCore:
    """Plan the local placement: lower (prog, mode) to an
    :class:`ExecutionCore` whose dense/sparse steps run on the CSR's
    device."""
    from ..kernels import ops as kops

    n, dev = csr.n_rows, csr.device
    rows, cols = csr.index64()
    vals = csr.values
    if prog.edge_op == "copy":
        vals = None
    elif vals is None:
        vals = torch.ones(csr.nnz, dtype=torch.float32, device=dev)
    deg = csr.degrees().long()
    iota = torch.arange(n, device=dev)
    ids_buf = torch.empty(C + 1, dtype=torch.int64, device=dev)
    all_active = None if kernel_bb is None else torch.ones(
        kernel_bb.n_tiles, dtype=torch.int32, device=dev)

    def dense(msg, frontier):
        if kernel_bb is not None:
            if prog.combine == "add":
                return kops.spmv_dma(kernel_bb, msg)[:n]
            # min/max: the SpMSpV kernel with every tile active is the
            # dense pass (there is no separate dense-combine kernel)
            return kops.spmspv_dma(kernel_bb, msg, all_active,
                                   combine=prog.combine)[:n]
        return _dense_step(rows, cols, vals, msg, n, prog)

    def sparse(msg, frontier, alive, edges):
        if kernel_bb is not None:
            return kops.spmspv_dma(kernel_bb, msg,
                                   tile_active(kernel_bb, frontier),
                                   combine=prog.combine)[:n]
        ids = _compact(frontier, alive, ids_buf, iota)
        return _sparse_step(csr.indptr, csr.indices, vals, msg, ids, edges,
                            n, prog)

    def count(frontier):
        act = frontier != 0
        return torch.stack([act.sum(), (deg * act).sum()])

    return ExecutionCore(msg=prog.msg_fn,
                         step=_direction_step(dense, sparse, mode, C),
                         update=prog.update_fn, count=count)


def run(csr: CSR, prog: VertexProgram, state0: Any, frontier0: torch.Tensor,
        *, max_iters: int, mode: str = "auto",
        push_capacity: Optional[int] = None,
        kernel_bb: Optional[BBCSR] = None, return_stats: bool = False):
    """Run `prog` to frontier exhaustion (or `max_iters`) on the CSR's
    device: validate, plan a local ExecutionCore, loop (the reference's
    `run` → `_run_local` → `_core_loop`).

    `state0` need not be the program's cold initial state — any feasible
    labeling works, with `frontier0` marking the vertices whose outgoing
    relaxations might still fire.

    mode: 'auto' (direction-optimizing), 'push' (always sparse), 'pull'
      (always dense).  'auto' switches on the frontier population count:
      sparse while it fits `push_capacity` (default n/32), dense otherwise.
    kernel_bb: BBCSR of A^T (see `build_pull_operand`) — routes both
      directions through the BBCSR SpMV/SpMSpV kernels.
    return_stats: also return {'iters', 'pushes', 'pulls'} taken.
    """
    if mode not in ("auto", "push", "pull"):
        raise ValueError(f"mode must be 'auto', 'push' or 'pull', got {mode!r}")
    n = csr.n_rows
    if push_capacity is None:
        push_capacity = n if mode == "push" else max(1, n // 32)
    C = min(push_capacity, n)
    if kernel_bb is not None:
        _check_kernel_operand(prog, kernel_bb)
    core = _local_core(csr, prog, mode=mode, C=C, kernel_bb=kernel_bb)
    state, stats = _core_loop(core, state0, frontier0, max_iters=max_iters)
    return (state, stats) if return_stats else state
