"""Direction-optimizing vertex-program execution engine (torch).

Counterpart of ``repro.core.engine`` on the local placement (one device),
with its three lane representations: ``scalar`` (one traversal, :func:`run`),
``valued`` (B traversals as (B, n) lanes, the single-source program vmapped
over them) and ``packed`` (B boolean traversals bit-packed into (n, W) int32
words, MS-BFS style), the last two through :func:`run_batched`.  Every
frontier algorithm of this package is the same loop: per-vertex *messages*
flow along edges and are combined at the destination, then a per-vertex
*update* produces the next state and the next frontier::

    msg  = msg_fn(state, frontier)            # (n,) — identity on inactive
    acc[v] = combine_{(u,v) in E} edge_op(msg[u], w_uv)
    state, frontier = update_fn(state, acc, frontier, it)

with ``edge_op`` in {mul, add, copy} and ``combine`` in {add, min, max}, or
the batched-only bitwise ``or`` over packed lane words.  Frontier masking is
folded into ``msg_fn`` (inactive vertices emit the combine identity), which
is what makes push and pull produce the same acc.

Direction optimization: the **sparse / push** step expands only the active
vertices' adjacency rows (work ∝ their edges); the **dense / pull** step is
one edge-parallel pass.  'auto' pushes while the active count fits the push
capacity (n/32 by default) and pulls otherwise.  With a BBCSR operand of A^T
(:func:`build_pull_operand`) both directions run on the BBCSR kernels
instead: the dense step is SpMV ('add') or SpMSpV with every tile active
('min' / 'max'), the sparse step SpMSpV over the tiles whose column block
holds an active vertex.

Batched lanes share one scan of the edges the **union frontier** touches:
the direction switch, the push compaction and the BBCSR tile schedule all
run on the union, and a lane inactive at a vertex emits the identity there.

The loop (:func:`_core_loop`) is a Python loop that reads one pair of
numbers from the device per level, the (union) active-vertex count and the
active vertices' edge total: the count decides termination and direction,
the total sizes the push step's edge buffer.
"""
# The `single-core` lint rule guards the JAX engine's lax.while_loop /
# shard_map runner seam.  This engine's one stepping loop is the Python loop
# in _core_loop, which both of its runners (run, run_batched) go through; it
# has no lax loop to count, and the distributed runners that the rule's
# shard_map checks are about are not ported yet, so the rule does not apply
# to this file.
# repro-lint: disable-file=single-core
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Optional

import torch

from .. import tune as _tune
from . import offload
from .graph import BBCSR, CSR, to_bbcsr

__all__ = ["VertexProgram", "ExecutionCore", "run", "run_batched",
           "build_pull_operand", "tile_active", "lane_words", "pack_lanes",
           "unpack_lanes", "fold_in", "sample_neighbors",
           "frontier_edge_capacity"]

_COMBINE_IDENTITY = {"add": 0.0, "min": float("inf"), "max": float("-inf"),
                     "or": 0}


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    """One frontier algorithm, reduced to its per-edge/per-vertex pieces.

    Attributes:
      edge_op:   how a message meets the edge weight: 'mul' | 'add' | 'copy'.
      combine:   destination-side reduction: 'add' | 'min' | 'max', or the
                 batched-only bitwise 'or' (messages are bit-packed int32
                 lane words, :func:`run_batched`; edge_op 'copy').  The
                 reference's structured combines are not ported yet.
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
                             "runs 'add', 'min', 'max' and 'or')")
        if self.combine == "or" and self.edge_op != "copy":
            raise ValueError("combine 'or' reduces bit-packed lane words — "
                             "edge values cannot weigh in: edge_op must be "
                             "'copy'")

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
# Bit-packed lanes (batched boolean frontiers, MS-BFS style)
# ---------------------------------------------------------------------------
# The words are int32, not the reference's uint32: torch has no shift,
# scatter or index_put for uint32 on the CPU.  The bits are the same, so a
# word equals the reference's viewed as int32; lane 31 is the sign bit.

def lane_words(n_lanes: int) -> int:
    """int32 words needed to bit-pack ``n_lanes`` boolean lanes."""
    return -(-n_lanes // 32)


def pack_lanes(bits: torch.Tensor) -> torch.Tensor:
    """(B, n) lane indicators -> (n, W) int32 words; lane b lives at bit
    b % 32 of word b // 32."""
    B, n = bits.shape
    W = lane_words(B)
    b = torch.nn.functional.pad((bits != 0).to(torch.int64),
                                (0, 0, 0, W * 32 - B)).reshape(W, 32, n)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    # lanes occupy disjoint bits, so the sum is the OR; a word over 2^31 - 1
    # wraps to its int32 bit pattern
    words = (b << shifts[None, :, None]).sum(dim=1).T
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def unpack_lanes(words: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """(n, W) int32 words -> (B, n) int32 {0, 1} lane indicators (the shift
    is arithmetic, so lane 31 is masked with & 1 after it)."""
    lanes = torch.arange(n_lanes, device=words.device)
    bits = (words[:, lanes // 32] >> (lanes % 32).to(torch.int32)) & 1
    return bits.T


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


# Keyed draws: splitmix64 (Steele, Lea and Flood's finalizer) on int64
# tensors.  Products wrap mod 2**64 on every device and the logical right
# shifts are arithmetic shifts masked to their width, so a key gives the same
# bits on the CPU and on the card, whatever tensor it sits in.
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix64(z: torch.Tensor) -> torch.Tensor:
    z = (z ^ _srl(z, 30)) * _MIX1
    z = (z ^ _srl(z, 27)) * _MIX2
    return z ^ _srl(z, 31)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """A new int64 draw key from ``key`` and ``data`` (int64 tensors or
    ints, broadcast): ``mix(mix(key + golden) ^ data)``, a bijection of
    ``data`` for a fixed ``key``.  Draws are built from explicit keys only,
    never from a global generator."""
    return _mix64(_mix64(key + _GOLDEN) ^ data)


def sample_neighbors(csr: CSR, queries: torch.Tensor, keys: torch.Tensor, *,
                     weighted: bool = False) -> torch.Tensor:
    """One uniform out-neighbour draw per query slot: (Q,) int32.

    ``keys`` (Q,) int64 are the slots' draw keys (:func:`fold_in`); a slot
    draws ``r`` = the top 30 bits of ``mix(key)`` and picks the row entry
    ``r mod degree`` — the reference's inverse-CDF draw, one random offset
    into the row.  The same key and graph give the same neighbour whatever
    the batch around the slot and whichever device runs it.  Sinks and
    negative queries return the query itself.  The weighted reservoir
    (``weighted=True``) needs the static row budget the port leaves out
    (``_max_degree``) and is refused.
    """
    if weighted:
        raise NotImplementedError(
            "the weighted reservoir draw is not ported (ROADMAP §A.4)")
    q = queries.long()
    safe = torch.clamp(q, min=0)
    start = csr.indptr[safe].long()
    deg = csr.indptr[safe + 1].long() - start
    r = _srl(_mix64(keys.long()), 34)
    off = start + r % torch.clamp(deg, min=1)
    nbr = offload.dma_gather(csr.indices, torch.where(deg > 0, off, -1))
    return torch.where((deg > 0) & (q >= 0), nbr.long(), q).to(torch.int32)


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


def _combine_lanes(contrib: torch.Tensor, cols: torch.Tensor, n: int,
                   prog: VertexProgram) -> torch.Tensor:
    """(B, E) contributions combined into (B, n) by destination ``cols``
    (E,) int64, every one in range; untouched entries get the identity."""
    B = contrib.shape[0]
    if prog.combine == "add":
        return contrib.new_zeros((B, n)).index_add_(1, cols, contrib)
    acc = contrib.new_full((B, n), prog.ident)
    return acc.scatter_reduce_(1, cols.expand(B, -1), contrib,
                               "amin" if prog.combine == "min" else "amax",
                               include_self=True)


def _kernel_lanes(bb: BBCSR, msg: torch.Tensor, prog: VertexProgram,
                  tile_sched: torch.Tensor) -> torch.Tensor:
    """One BBCSR SpMSpV launch per lane, sharing the union-frontier tile
    schedule: a tile inactive for every lane is skipped for all of them,
    and lanes inactive on an active tile contribute combine identities."""
    from ..kernels import ops as kops
    n = bb.n_rows
    return torch.stack([kops.spmspv_dma(bb, msg[b], tile_sched,
                                        combine=prog.combine)[:n]
                        for b in range(msg.shape[0])])


# operand id -> whether its values are all 0 or 1; an entry is dropped when
# its operand is collected, so a recycled id cannot alias
_UNIT_OPERANDS: dict = {}


def _unit_valued(vals: torch.Tensor) -> bool:
    return bool(((vals == 0) | (vals == 1)).all())


def _operand_is_unit(bb: BBCSR) -> bool:
    """Whether every stored value of ``bb`` is 0 or 1.  The values are read
    from the device once per operand (907 M slots at RMAT-20) and the answer
    kept by the operand's identity: an operand's arrays are not written
    after ``to_bbcsr`` builds them."""
    key = id(bb)
    hit = _UNIT_OPERANDS.get(key)
    if hit is None:
        hit = _UNIT_OPERANDS[key] = _unit_valued(bb.vals)
        weakref.finalize(bb, _UNIT_OPERANDS.pop, key, None)
    return hit


def _check_kernel_operand(prog: VertexProgram, kernel_bb: BBCSR) -> None:
    """Validate a BBCSR operand against the program's semiring: 'add'
    accumulates val*msg; 'min'/'max' relax msg + w."""
    if prog.combine == "add":
        if prog.edge_op == "add":
            raise ValueError("the 'add'-combine kernels compute val*msg; "
                             "edge_op 'add' has no kernel path")
        if prog.edge_op == "copy" and not _operand_is_unit(kernel_bb):
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
    """One lowered (program, lane representation, placement) point.  The
    runner *plans* (builds these four callables), the core *steps*
    (:func:`_core_loop`).

      msg:    (state, frontier) -> messages (vmapped for valued lanes).
      step:   (msg, frontier, alive, edges) -> (acc, was_push): the level's
              direction decision and the chosen step; ``alive`` and
              ``edges`` are the host-side counts of this level.
      update: (state, acc, frontier, it) -> (state, next_frontier).
      count:  frontier -> (2,) int64 device tensor [active vertices of the
              union frontier, their out-edges].
    """

    msg: Callable
    step: Callable
    update: Callable
    count: Callable


def _lane_ops(prog: VertexProgram, lanes: str):
    """The lane-representation axis ('scalar', 'valued' or 'packed'): how
    msg/update see the lane dim and how a frontier collapses to the
    per-vertex union indicator (bool)."""
    if lanes == "valued":
        return (torch.func.vmap(prog.msg_fn),
                torch.func.vmap(prog.update_fn, in_dims=(0, 0, 0, None)),
                lambda f: (f > 0).any(0))
    if lanes == "packed":
        return prog.msg_fn, prog.update_fn, lambda f: (f != 0).any(-1)
    return prog.msg_fn, prog.update_fn, lambda f: f != 0


def _core_loop(core: ExecutionCore, state0: Any, frontier0: torch.Tensor, *,
               max_iters: int, trace_len: int = 0):
    """Run an :class:`ExecutionCore` to frontier exhaustion (or
    `max_iters`).  The engine's only stepping loop.  Each level reads the
    carried counts to the host once; that one read serves the termination
    test, the direction choice and the push step's buffer size.  Returns
    ``(state, stats)`` with stats = {'iters', 'pushes', 'pulls'} (ints).

    trace_len > 0 adds ``stats['trace']``, a (trace_len, 4) int32 tensor on
    the frontier's device with one row ``[frontier, was_push, fallback,
    flush]`` per level (levels past trace_len dropped, rows after the last
    level 0).  ``frontier`` is the active count entering the level and
    ``fallback`` / ``flush`` are 0 on the local placement.  The rows are
    the host-side counts the loop already holds, so tracing adds no device
    read, and made into one tensor after the loop."""
    state, frontier = state0, frontier0
    it = pushes = 0
    rows = []
    counts = core.count(frontier)
    while it < max_iters:
        alive, edges = counts.tolist()
        if alive == 0:
            break
        msg = core.msg(state, frontier)
        acc, was_push = core.step(msg, frontier, alive, edges)
        state, frontier = core.update(state, acc, frontier, it)
        counts = core.count(frontier)
        if it < trace_len:
            rows.append((alive, was_push, 0, 0))
        it += 1
        pushes += was_push
    stats = {"iters": it, "pushes": pushes, "pulls": it - pushes}
    if trace_len:
        rows += [(0, 0, 0, 0)] * (trace_len - len(rows))
        stats["trace"] = torch.tensor(rows, dtype=torch.int32,
                                      device=frontier0.device)
    return state, stats


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

# CSR id -> (src, dst) of its destination-sorted edge stream; an entry is
# dropped when its graph is collected, so a recycled id cannot alias
_DST_SORTED: dict = {}


def _dst_sorted_stream(csr: CSR):
    """(src int64, dst int32) edge stream sorted by destination — the packed
    dense step's presorted segment_or input, on the CSR's device.
    Graph-only data, so the sort is kept per CSR, by object identity."""
    key = id(csr)
    hit = _DST_SORTED.get(key)
    if hit is None:
        dst, order = torch.sort(csr.indices, stable=True)
        hit = _DST_SORTED[key] = (csr.index64()[0][order], dst)
        weakref.finalize(csr, _DST_SORTED.pop, key, None)
    return hit


def _local_core(csr: CSR, prog: VertexProgram, *, mode: str, C: int,
                kernel_bb: Optional[BBCSR],
                lanes: str = "scalar") -> ExecutionCore:
    """Plan the local placement: lower (prog, lanes, mode) to an
    :class:`ExecutionCore` whose dense/sparse steps run on the CSR's
    device."""
    from ..kernels import ops as kops

    msg_of, update, union = _lane_ops(prog, lanes)
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

    def push_stream(frontier, alive, edges):
        """The union-active vertices' out-edges: (their position in ids,
        destination, edge value or None), and ids."""
        ids = _compact(union(frontier), alive, ids_buf, iota)
        return _gather_rows(csr.indptr, csr.indices, vals, ids, edges), ids

    if lanes == "scalar":
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
            return _sparse_step(csr.indptr, csr.indices, vals, msg, ids,
                                edges, n, prog)

    elif lanes == "packed":
        p_src, p_dst = _dst_sorted_stream(csr)

        def dense(msg, frontier):
            return offload.segment_or(p_dst, msg[p_src], n, presorted=True)

        def sparse(msg, frontier, alive, edges):
            (seg, ecols, _), ids = push_stream(frontier, alive, edges)
            return offload.segment_or(ecols, msg[ids[seg]], n)

    else:  # valued: msg (B, n)
        def dense(msg, frontier):
            if kernel_bb is not None:
                return _kernel_lanes(kernel_bb, msg, prog, all_active)
            em = msg[:, rows]                                   # (B, m)
            return _combine_lanes(_apply_edge(
                em, None if vals is None else vals[None, :], prog.edge_op),
                cols, n, prog)

        def sparse(msg, frontier, alive, edges):
            if kernel_bb is not None:
                return _kernel_lanes(kernel_bb, msg, prog,
                                     tile_active(kernel_bb, union(frontier)))
            (seg, ecols, w), ids = push_stream(frontier, alive, edges)
            em = msg[:, ids[seg]]                               # (B, E)
            return _combine_lanes(_apply_edge(
                em, None if w is None else w.to(msg.dtype)[None, :],
                prog.edge_op), ecols, n, prog)

    def count(frontier):
        act = union(frontier)
        return torch.stack([act.sum(), (deg * act).sum()])

    return ExecutionCore(msg=msg_of,
                         step=_direction_step(dense, sparse, mode, C),
                         update=update, count=count)


def _trace_len_of(trace: bool, trace_len, max_iters,
                  return_stats: bool) -> int:
    """Resolve the runners' (trace, trace_len) opt-in to a buffer length
    (0 = tracing off).  The trace rides the stats dict, so tracing requires
    return_stats; the default buffer covers min(max_iters, 512) levels."""
    if not trace:
        if trace_len is not None:
            raise ValueError("trace_len is only meaningful with trace=True")
        return 0
    if not return_stats:
        raise ValueError("trace=True returns stats['trace']: pass "
                         "return_stats=True as well")
    n = int(trace_len) if trace_len is not None else min(int(max_iters), 512)
    if n < 1:
        raise ValueError(f"trace_len must be >= 1, got {n}")
    return n


def _run_local(csr: CSR, prog: VertexProgram, lanes: str, state0, frontier0,
               *, max_iters, mode, push_capacity, kernel_bb, return_stats,
               trace, trace_len):
    """Shared local runner: validate, plan a local ExecutionCore, loop."""
    if mode not in ("auto", "push", "pull"):
        raise ValueError(f"mode must be 'auto', 'push' or 'pull', got {mode!r}")
    n_trace = _trace_len_of(trace, trace_len, max_iters, return_stats)
    n = csr.n_rows
    if push_capacity is None:
        push_capacity = n if mode == "push" else max(1, n // 32)
    C = min(push_capacity, n)
    if kernel_bb is not None:
        _check_kernel_operand(prog, kernel_bb)
    core = _local_core(csr, prog, mode=mode, C=C, kernel_bb=kernel_bb,
                       lanes=lanes)
    state, stats = _core_loop(core, state0, frontier0, max_iters=max_iters,
                              trace_len=n_trace)
    return (state, stats) if return_stats else state


def run(csr: CSR, prog: VertexProgram, state0: Any, frontier0: torch.Tensor,
        *, max_iters: int, mode: str = "auto",
        push_capacity: Optional[int] = None,
        kernel_bb: Optional[BBCSR] = None, return_stats: bool = False,
        trace: bool = False, trace_len: Optional[int] = None):
    """Run `prog` to frontier exhaustion (or `max_iters`) on the CSR's
    device: the (scalar lanes, local placement) point of the reference's
    grid (`run` → `_run_local` → `_core_loop`).

    `state0` need not be the program's cold initial state — any feasible
    labeling works, with `frontier0` marking the vertices whose outgoing
    relaxations might still fire.

    mode: 'auto' (direction-optimizing), 'push' (always sparse), 'pull'
      (always dense).  'auto' switches on the frontier population count:
      sparse while it fits `push_capacity` (default n/32), dense otherwise.
    kernel_bb: BBCSR of A^T (see `build_pull_operand`) — routes both
      directions through the BBCSR SpMV/SpMSpV kernels.
    return_stats: also return {'iters', 'pushes', 'pulls'} taken.
    trace: with return_stats, also return the per-level trace
      (``stats['trace']``, see :func:`_core_loop`; decoded by
      `repro_torch.obs.decode_level_trace`); trace_len overrides the
      default min(max_iters, 512)-row buffer.  Results are the same with
      tracing on or off.
    """
    if prog.combine == "or":
        raise ValueError("combine='or' is the batched bitwise combine: run it "
                         "through run_batched")
    return _run_local(csr, prog, "scalar", state0, frontier0,
                      max_iters=max_iters, mode=mode,
                      push_capacity=push_capacity, kernel_bb=kernel_bb,
                      return_stats=return_stats, trace=trace,
                      trace_len=trace_len)


def run_batched(csr: CSR, prog: VertexProgram, state0: Any,
                frontier0: torch.Tensor, *, max_iters: int,
                mode: str = "auto", push_capacity: Optional[int] = None,
                kernel_bb: Optional[BBCSR] = None,
                return_stats: bool = False, trace: bool = False,
                trace_len: Optional[int] = None):
    """Run ``prog`` for a *batch* of sources in one pass over the graph:
    per level the engine scans the edges the union frontier touches once
    and carries all B lanes through that scan.

    * ``combine='or'`` — **bit-packed boolean lanes**: frontier and messages
      are (n, W) int32 words, W = ceil(B/32); the destination combine is a
      bitwise OR (:func:`offload.segment_or`).  The program is written
      against packed words (see ``bfs.msbfs_program``).
    * any other combine — **valued lanes**: frontier and state leaves are
      (B, n) (a per-lane scalar is (B,)), and ``msg_fn`` / ``update_fn`` are
      the single-source functions, vmapped over the lane axis.  Each lane
      sees the same per-edge arithmetic as a :func:`run` of its own, and a
      lane whose frontier has emptied emits identities until the whole
      batch drains.

    mode: as :func:`run`; 'auto' switches on the union frontier's count.
    kernel_bb routes the valued dense and sparse steps through the BBCSR
      SpMSpV kernel (combine 'add' on a unit operand, or 'min' / 'max'),
      one launch per lane per level, all lanes sharing the union
      frontier's tile schedule (every tile on a dense level).  Packed lanes
      have no kernel combine.  (The reference's structured combines cannot
      be lane-batched; the port's VertexProgram does not take them.)
    Returns the final state; ``return_stats`` / ``trace`` / ``trace_len`` as
    :func:`run`, the trace rows describing the shared union-frontier scan.
    """
    packed = prog.combine == "or"
    if kernel_bb is not None and packed:
        raise ValueError("the BBCSR kernels carry f32 payloads: bit-packed"
                         " 'or' lanes have no kernel combine")
    return _run_local(csr, prog, "packed" if packed else "valued", state0,
                      frontier0, max_iters=max_iters, mode=mode,
                      push_capacity=push_capacity, kernel_bb=kernel_bb,
                      return_stats=return_stats, trace=trace,
                      trace_len=trace_len)


def frontier_edge_capacity(m: int, switch_frac: float, *,
                           slack: Optional[float] = None) -> int:
    """Per-peer routing capacity for the compacted sparse push.

    While the engine is in the push regime the frontier holds at most
    ``switch_frac * n`` vertices, so with edges spread uniformly a shard sees
    about ``switch_frac * m`` active edges; ``slack`` covers degree skew.
    The local placement routes nothing: the service's route-byte model
    (``traffic.push_level_route_bytes``) prices its push levels at this
    capacity.  ``slack`` None takes ``engine.push_slack``
    (``repro_torch.tune``).
    """
    slack = _tune.resolve("engine.push_slack", slack)
    return max(1, min(m, int(m * switch_frac * slack)))
