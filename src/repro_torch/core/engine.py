"""Direction-optimizing vertex-program execution engine (torch).

Counterpart of ``repro.core.engine``.  Every frontier algorithm of this
package is the same loop: per-vertex *messages* flow along edges and are
combined at the destination, then a per-vertex *update* produces the next
state and the next frontier::

    msg  = msg_fn(state, frontier)            # (n,) — identity on inactive
    acc[v] = combine_{(u,v) in E} edge_op(msg[u], w_uv)
    state, frontier = update_fn(state, acc, frontier, it)

with ``edge_op`` in {mul, add, copy} and ``combine`` in {add, min, max}, or
the batched-only bitwise ``or`` over packed lane words.  Frontier masking is
folded into ``msg_fn`` (inactive vertices emit the combine identity), which
is what makes push and pull produce the same acc.

Two axes pick a point of the grid.  The **lane representation**:
``scalar`` (one traversal), ``valued`` (B traversals as (B, n) lanes, the
single-source program vmapped over them) and ``packed`` (B boolean
traversals bit-packed into (n, W) int32 words, MS-BFS style).  The
**placement**: ``local`` (one device: :func:`run`, :func:`run_batched`)
or ``distributed`` (:func:`run_distributed`, :func:`run_batched_distributed`:
one rank per shard of a ``launch.mesh.Mesh``, every rank running the same
call on its own rows, owner-routed exchanges through ``offload``, one
all-reduced count per level so every rank takes the same branch), the
latter ``sync`` or ``async`` (bounded-staleness pacing: each rank runs
``sync_interval`` - 1 collective-free micro-steps against its resident
partition between global checks, deferring remote contributions into a
dense combine outbox that one ``offload.buffered_flush`` delivers).

The *structured* combines ``argmax_weighted`` and ``sample`` carry an int32
payload message (-1 = inactive) and give the update a (score, payload)
pair: the weighted label mode of the incoming payloads
(:func:`offload.segment_weighted_mode`, LPA's and Louvain's vote), or one
keyed random pick among them (:func:`offload.segment_argmax` over
priorities drawn from the run's ``key``, uniform for edge_op 'copy' and
weighted by the edge value for 'mul').  A pick's priority is keyed on the
edge's CSR position and the level, not on its place in the step's stream,
so push and pull draw the same priority for the same edge and pick alike.

Direction optimization: the **sparse / push** step expands only the active
vertices' adjacency rows (work ∝ their edges); the **dense / pull** step is
one edge-parallel pass.  'auto' pushes while the active count fits the push
capacity (n/32 by default) and pulls otherwise.  With a BBCSR operand of A^T
(:func:`build_pull_operand`) both local directions run on the BBCSR kernels
instead: the dense step is SpMV ('add') or SpMSpV with every tile active
('min' / 'max'), the sparse step SpMSpV over the tiles whose column block
holds an active vertex.

Batched lanes share one scan of the edges the **union frontier** touches:
the direction switch, the push compaction and the BBCSR tile schedule all
run on the union, and a lane inactive at a vertex emits the identity there.

The loop (:func:`_core_loop`) is a Python loop that reads one small count
vector from the device per level: the (union) active-vertex count, the
active vertices' edge total and, distributed, the shards whose active
edges overflow the compacted push capacity.  The count decides
termination and direction, the total sizes the local push step's edge
buffer, the overflow flag the compaction.
"""
# The `single-core` lint rule counts the JAX engine's lax loops and checks
# its runner seam.  This engine has no lax loop to count: its one stepping
# loop is the Python loop in _core_loop, which every runner of both
# placements goes through (run / run_batched via _run_local,
# run_distributed / run_batched_distributed via _run_distributed), and its
# one fixed-length step sequence is _scan_steps, which drives both the
# async placement's micro-steps (inside the loop's pace hook) and
# run_queue's per-iteration body, as in the reference.  So the rule does
# not apply to this file.
# repro-lint: disable-file=single-core
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Callable, Optional

import torch

from .. import tune as _tune
from . import offload
from .graph import BBCSR, CSR, to_bbcsr

__all__ = ["VertexProgram", "ExecutionCore", "run", "run_batched",
           "run_distributed", "run_batched_distributed", "spmv_pass",
           "reverse_graph", "QueueProgram", "run_queue",
           "build_pull_operand", "tile_active", "lane_words", "pack_lanes",
           "unpack_lanes", "fold_in", "sample_neighbors",
           "frontier_edge_capacity", "Hierarchy", "run_multilevel"]

_COMBINE_IDENTITY = {"add": 0.0, "min": float("inf"), "max": float("-inf"),
                     "or": 0}
_STRUCTURED_COMBINES = ("argmax_weighted", "sample")


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    """One frontier algorithm, reduced to its per-edge/per-vertex pieces.

    Attributes:
      edge_op:   how a message meets the edge weight: 'mul' | 'add' | 'copy'.
      combine:   destination-side reduction: 'add' | 'min' | 'max', or a
                 structured combine 'argmax_weighted' | 'sample' (the message
                 is then an int32 payload, -1 = inactive, and `acc` is the
                 (score, payload) pair; scalar lanes only), or the
                 batched-only bitwise 'or' (messages are bit-packed int32
                 lane words, :func:`run_batched`; edge_op 'copy').
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
        if (self.combine not in _COMBINE_IDENTITY
                and self.combine not in _STRUCTURED_COMBINES):
            raise ValueError(f"unknown combine {self.combine!r} (this engine "
                             "runs 'add', 'min', 'max', 'argmax_weighted', "
                             "'sample' and 'or')")
        if self.structured and self.edge_op == "add":
            raise ValueError(f"combine {self.combine!r} takes its weight from "
                             "the edge value: edge_op must be 'mul' (weighted)"
                             " or 'copy' (unit)")
        if self.combine == "or" and self.edge_op != "copy":
            raise ValueError("combine 'or' reduces bit-packed lane words — "
                             "edge values cannot weigh in: edge_op must be "
                             "'copy'")

    @property
    def structured(self) -> bool:
        """True for the combines whose acc is a (score, payload) pair rather
        than a single reduced value."""
        return self.combine in _STRUCTURED_COMBINES

    @property
    def ident(self):
        if self.identity is not None:
            return self.identity
        if self.structured:
            return float("-inf")  # score identity; payload identity is -1
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
    """Scatter-{add,min,max} of ``vals`` into ``dest`` in place, indices
    outside [0, len(dest)) dropped; ``vals`` may carry trailing lane dims
    beyond ``idx`` (``dest`` then carries the same).  Returns ``dest``."""
    valid = (idx >= 0) & (idx < dest.shape[0])
    mask = valid.reshape(valid.shape + (1,) * (vals.dim() - 1))
    masked = torch.where(mask, vals.to(dest.dtype),
                         dest.new_full((), identity))
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    if combine == "add":
        return dest.index_add_(0, safe, masked)
    return dest.scatter_reduce_(0, safe.reshape(mask.shape).expand_as(masked),
                                masked, "amin" if combine == "min" else "amax",
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

    The tile geometry defaults to the tuned entry of ``combine``'s kernel
    family for the CSR's device type and graph scale
    (:mod:`repro_torch.tune`); explicit ``block_rows=`` / ``block_cols=``
    / ``tile_nnz=`` kwargs win per key."""
    family = "bbcsr_min" if combine in ("min", "max") else "bbcsr_add"
    params = {k: _tune.resolve(f"kernels.{family}.{k}", bb_kwargs.get(k),
                               n=csr.n_rows, device=csr.device)
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

def _row_positions(indptr, ids, total: int, k: Optional[int] = None):
    """The CSR positions of the adjacency rows of ``ids`` (padding id = -1)
    as one flat stream, at most ``k`` entries per row (all when None).

    ``total`` is the stream's length (the sum of the rows' capped degrees),
    known to the caller, so nothing here waits on the device.  Returns
    (seg (total,) int64 — the position in ``ids`` each entry came from,
    pos (total,) int64 — its CSR position).  Rows are expanded in ``ids``
    order, each in CSR order.
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
    return seg, start[seg] + torch.arange(total, device=ids.device) - \
        first[seg]


def _gather_rows(indptr, indices, vals, ids, total: int,
                 k: Optional[int] = None):
    """DMA-gather the adjacency rows of ``ids`` as one flat edge stream
    (:func:`_row_positions`).  Returns (seg (total,) int64, cols (total,)
    int64, w (total,) edge values or None)."""
    seg, pos = _row_positions(indptr, ids, total, k)
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


def as_key(key, device) -> torch.Tensor:
    """A draw key as a 0-d int64 tensor on ``device``: an int is taken mod
    2**64 and read as int64; a tensor is moved there."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device, dtype=torch.int64)
    key = int(key) % (1 << 64)
    return torch.tensor(key - (1 << 64) if key >= 1 << 63 else key,
                        dtype=torch.int64, device=device)


def _uniform(z: torch.Tensor) -> torch.Tensor:
    """f32 uniforms in (0, 1) from mixed int64 draws: the top 23 bits r of
    each, as (r + 0.5) / 2**23 (exact in f32)."""
    return (_srl(z, 41).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


def _es_scores(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Efraimidis–Spirakis reservoir priorities in the log domain: the max
    of log(u_i) / w_i picks item i with probability w_i / sum(w) (the order
    of u_i^(1/w_i), without its underflow at small w); non-positive weights
    never win."""
    return torch.where(w > 0, torch.log(u) / torch.clamp(w, min=1e-30),
                       float("-inf"))


def sample_neighbors(csr: CSR, queries: torch.Tensor, keys: torch.Tensor, *,
                     weighted: bool = False) -> torch.Tensor:
    """One out-neighbour draw per query slot: (Q,) int32.

    ``keys`` (Q,) int64 are the slots' draw keys (:func:`fold_in`).
    Unweighted, a slot draws ``r`` = the top 30 bits of ``mix(key)`` and
    picks the row entry ``r mod degree`` — the reference's inverse-CDF draw,
    one random offset into the row.  ``weighted=True`` draws an entry with
    probability proportional to its edge value (values <= 0 never drawn),
    the distribution of the reference's keyed reservoir over the gathered
    row, by the same lowering to an inverse-CDF draw: a slot takes ``u``
    from the top 53 bits of ``mix(key)`` and picks the entry where ``u``
    times the row's total falls in the row's prefix sums of values (float64,
    kept per CSR), O(log degree) a slot instead of a gather of its row.  A
    row whose values are all <= 0 gives its first entry, as the reference's
    argmax does.  The same key and graph give the same neighbour whatever
    the batch around the slot.  Sinks and negative queries return the query
    itself.
    """
    q = queries.long()
    safe = torch.clamp(q, min=0)
    start = csr.indptr[safe].long()
    deg = csr.indptr[safe + 1].long() - start
    z = _mix64(keys.long())
    if weighted:
        cum = csr.weight_prefix()
        lo, hi = cum[start], cum[start + deg]
        u = _srl(z, 11).to(torch.float64) * 2.0 ** -53
        pos = torch.searchsorted(cum, lo + u * (hi - lo), right=True) - 1
        off = torch.where(hi > lo, torch.minimum(
            torch.maximum(pos, start), start + deg - 1), start)
    else:
        off = start + _srl(z, 34) % torch.clamp(deg, min=1)
    nbr = offload.dma_gather(csr.indices, torch.where(deg > 0, off, -1))
    return torch.where((deg > 0) & (q >= 0), nbr.long(), q).to(torch.int32)


def _structured_combine(idx, payload, w, pos, n, prog: VertexProgram,
                        it_key):
    """Edge-stream entry to the structured combines: idx = destination per
    item, payload = int message (-1: inactive, ignored), w = edge weight,
    pos = the item's CSR position (the 'sample' draw's key)."""
    idx = torch.where(payload >= 0, idx, -1)
    if prog.combine == "argmax_weighted":
        return offload.segment_weighted_mode(idx, payload, w, n)
    # 'sample': keyed reservoir pick — iid priorities per (level, edge), so
    # the per-destination argmax is a uniform pick; Efraimidis–Spirakis
    # priorities weight it by the edge value when edge_op='mul'
    u = _uniform(fold_in(it_key, pos))
    score = _es_scores(u, w) if prog.edge_op == "mul" else u
    return offload.segment_argmax(idx, score, payload, n)


def _dense_step(rows, cols, vals, msg, n, prog: VertexProgram, it_key=None):
    """Pull direction: one edge-parallel pass over every edge (``rows`` /
    ``cols`` int64)."""
    if prog.structured:
        w = vals if vals is not None else torch.ones(
            rows.shape[0], dtype=torch.float32, device=rows.device)
        pos = None if prog.combine != "sample" else torch.arange(
            rows.shape[0], device=rows.device)
        return _structured_combine(cols, msg[rows].to(torch.int32), w, pos,
                                   n, prog, it_key)
    em = msg[rows]
    ev = _apply_edge(em, vals, prog.edge_op)
    if prog.combine == "add":
        return torch.zeros(n, dtype=msg.dtype, device=msg.device).index_add_(
            0, cols, ev.to(msg.dtype))
    return _scatter_combine(_acc_init(n, prog, msg.dtype, msg.device), cols,
                            ev, prog.combine, prog.ident)


def _sparse_step(indptr, indices, vals, msg, ids, n_edges: int, n,
                 prog: VertexProgram, it_key=None):
    """Push direction: expand only the active vertices' adjacency rows
    (``ids``, their ``n_edges`` edges, at their exact degrees) and
    scatter-combine them."""
    if prog.structured:
        seg, pos = _row_positions(indptr, ids, n_edges)
        w = vals[pos].to(torch.float32) if vals is not None else torch.ones(
            n_edges, dtype=torch.float32, device=ids.device)
        return _structured_combine(indices[pos].long(),
                                   msg[ids.long()][seg].to(torch.int32), w,
                                   pos, n, prog, it_key)
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
    runner *plans* (builds these callables), the core *steps*
    (:func:`_core_loop`).

      msg:    (state, frontier) -> messages (vmapped for valued lanes).
      step:   (msg, frontier, counts, it_key) -> (acc, was_push, fallback):
              the level's direction decision and the chosen step;
              ``counts`` is the host-side tuple the level's ``count`` gave
              (active vertices of the union frontier, their out-edges, and
              under the distributed placement the shards whose active edges
              overflow the compacted push capacity), ``it_key`` the level's
              draw key (None without a run key).
      update: (state, acc, frontier, it) -> (state, next_frontier).
      count:  frontier -> small int64 device tensor [active vertices,
              their out-edges, overflowing shards] (the last 0 locally);
              one all-reduce under the distributed placement, so every
              rank reads the same numbers and takes the same branch.
      pace:   optional (state, frontier, it) -> (state, frontier, it), run
              at the top of every level: the async placement's
              sync_interval-1 collective-free local micro-steps before the
              globally-checked step.  None keeps every level synchronous.
    """

    msg: Callable
    step: Callable
    update: Callable
    count: Callable
    pace: Optional[Callable] = None


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
               max_iters: int, key: Optional[torch.Tensor] = None,
               trace_len: int = 0, trace_flush: bool = False):
    """Run an :class:`ExecutionCore` to frontier exhaustion (or
    `max_iters`).  The engine's only stepping loop, for both placements.
    Each level reads the carried counts to the host once; that one read
    serves the termination test, the direction choice, the push step's
    buffer size and (distributed) the compaction's overflow branch.  With
    a ``key`` each level draws from ``fold_in(key, it)``, as the reference
    folds its PRNG key.  Returns ``(state, stats)`` with stats =
    {'iters', 'pushes', 'pulls', 'fallbacks'} (ints; the local runners drop
    'fallbacks', as the reference's do).

    trace_len > 0 adds ``stats['trace']``, a (trace_len, 4) int32 tensor on
    the frontier's device with one row ``[frontier, was_push, fallback,
    flush]`` per level (levels past trace_len dropped, rows after the last
    level 0).  ``frontier`` is the active count entering the level,
    ``flush`` mirrors ``was_push`` only with ``trace_flush`` (the async
    placement, whose checked step is the outbox flush).  The rows are the
    host-side counts the loop already holds, so tracing adds no device
    read, and made into one tensor after the loop."""
    state, frontier = state0, frontier0
    it = level = pushes = fallbacks = 0
    rows = []
    counts = core.count(frontier)
    while it < max_iters:
        host = tuple(counts.tolist())
        alive = host[0]
        if alive == 0:
            break
        if core.pace is not None:
            state, frontier, it = core.pace(state, frontier, it)
        msg = core.msg(state, frontier)
        it_key = None if key is None else fold_in(key, it)
        acc, was_push, fb = core.step(msg, frontier, host, it_key)
        state, frontier = core.update(state, acc, frontier, it)
        counts = core.count(frontier)
        if level < trace_len:
            rows.append((alive, was_push, fb, was_push if trace_flush else 0))
        it += 1
        level += 1
        pushes += was_push
        fallbacks += fb
    stats = {"iters": it, "pushes": pushes, "pulls": level - pushes,
             "fallbacks": fallbacks}
    if trace_len:
        rows += [(0, 0, 0, 0)] * (trace_len - len(rows))
        stats["trace"] = torch.tensor(rows, dtype=torch.int32,
                                      device=frontier0.device)
    return state, stats


def _scan_steps(body, carry, n: int, it0: int):
    """The engine's one fixed-length step sequence: ``n`` calls of
    ``body(carry, it0 + j)`` (the async placement's collective-free
    micro-steps, :func:`run_queue`'s iterations), as the reference's
    ``_scan_steps`` scans them."""
    for j in range(n):
        carry = body(carry, it0 + j)
    return carry


def _direction_step(dense, sparse, mode: str, threshold: int):
    """'pull' always takes the dense step; 'push' / 'auto' take the sparse
    step while the active count fits ``threshold`` (the push capacity) and
    fall back to dense above it."""
    if mode == "pull":
        def step(msg, frontier, counts, it_key):
            return dense(msg, frontier, it_key), 0, 0
        return step

    def step(msg, frontier, counts, it_key):
        alive, edges = counts[0], counts[1]
        if alive <= threshold:
            return sparse(msg, frontier, alive, edges, it_key), 1, 0
        return dense(msg, frontier, it_key), 0, 0
    return step


# ---------------------------------------------------------------------------
# Local placement
# ---------------------------------------------------------------------------

# CSR id -> (src, dst, order) of its destination-sorted edge stream; an
# entry is dropped when its graph is collected, so a recycled id cannot alias
_DST_SORTED: dict = {}


def _dst_sorted(csr: CSR):
    """(src int64, dst int32, order int64) of the edge stream sorted stably
    by destination, on the CSR's device (Louvain's pull stream; the packed
    dense step reads its CSR form, :func:`_dst_csr`): ``order`` maps it
    back to CSR positions (edge values in that order are
    ``values[order]``), and each destination's edges keep their CSR order.
    Graph-only data, so the sort is kept per CSR, by object identity."""
    key = id(csr)
    hit = _DST_SORTED.get(key)
    if hit is None:
        dst, order = torch.sort(csr.indices, stable=True)
        hit = _DST_SORTED[key] = (csr.index64()[0][order], dst, order)
        weakref.finalize(csr, _DST_SORTED.pop, key, None)
    return hit


# CSR id -> (offsets, src) of the same stream in CSR form by destination
_DST_CSR: dict = {}


def _dst_csr(csr: CSR):
    """(offsets int32 (n + 1,), src int32 (m,)) of the edge stream sorted
    stably by destination, on the CSR's device — the packed dense step's
    ``offload.segment_or_rows`` operand: destination v's edges are
    ``src[offsets[v]:offsets[v + 1]]``, in CSR order.  Graph-only data,
    kept per CSR by object identity as :func:`_dst_sorted` keeps its own;
    raises where n or m does not fit int32."""
    key = id(csr)
    hit = _DST_CSR.get(key)
    if hit is None:
        n, m = csr.n_rows, csr.nnz
        if max(n + 1, m) > 2 ** 31 - 1:
            raise ValueError(f"the dense OR step needs n + 1 and m within "
                             f"int32, got n={n}, m={m}")
        dst, order = torch.sort(csr.indices, stable=True)
        offsets = torch.searchsorted(
            dst, torch.arange(n + 1, dtype=dst.dtype, device=dst.device),
            out_int32=True)
        hit = _DST_CSR[key] = (offsets, csr.row_ids()[order])
        weakref.finalize(csr, _DST_CSR.pop, key, None)
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
        def dense(msg, frontier, it_key):
            if kernel_bb is not None:
                if prog.combine == "add":
                    return kops.spmv_dma(kernel_bb, msg)[:n]
                # min/max: the SpMSpV kernel with every tile active is the
                # dense pass (there is no separate dense-combine kernel)
                return kops.spmspv_dma(kernel_bb, msg, all_active,
                                       combine=prog.combine)[:n]
            return _dense_step(rows, cols, vals, msg, n, prog, it_key)

        def sparse(msg, frontier, alive, edges, it_key):
            if kernel_bb is not None:
                return kops.spmspv_dma(kernel_bb, msg,
                                       tile_active(kernel_bb, frontier),
                                       combine=prog.combine)[:n]
            ids = _compact(frontier, alive, ids_buf, iota)
            return _sparse_step(csr.indptr, csr.indices, vals, msg, ids,
                                edges, n, prog, it_key)

    elif lanes == "packed":
        p_off, p_src = _dst_csr(csr)

        def dense(msg, frontier, it_key):
            return offload.segment_or_rows(p_off, p_src, msg, n)

        def sparse(msg, frontier, alive, edges, it_key):
            (seg, ecols, _), ids = push_stream(frontier, alive, edges)
            return offload.segment_or(ecols, msg[ids[seg]], n)

    else:  # valued: msg (B, n)
        def dense(msg, frontier, it_key):
            if kernel_bb is not None:
                return _kernel_lanes(kernel_bb, msg, prog, all_active)
            em = msg[:, rows]                                   # (B, m)
            return _combine_lanes(_apply_edge(
                em, None if vals is None else vals[None, :], prog.edge_op),
                cols, n, prog)

        def sparse(msg, frontier, alive, edges, it_key):
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
        return torch.stack([act.sum(), (deg * act).sum(),
                            torch.zeros((), dtype=torch.int64, device=dev)])

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
               trace, trace_len, key=None):
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
                              key=None if key is None else as_key(
                                  key, csr.device), trace_len=n_trace)
    if not return_stats:
        return state
    del stats["fallbacks"]   # the local placement routes nothing
    return state, stats


def run(csr: CSR, prog: VertexProgram, state0: Any, frontier0: torch.Tensor,
        *, max_iters: int, mode: str = "auto",
        push_capacity: Optional[int] = None,
        kernel_bb: Optional[BBCSR] = None, key=None,
        return_stats: bool = False, trace: bool = False,
        trace_len: Optional[int] = None):
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
      directions through the BBCSR SpMV/SpMSpV kernels (not for the
      structured combines, as in the reference).
    key: int64 draw key (an int or a 0-d tensor), required for
      combine='sample'; level ``it`` draws from ``fold_in(key, it)``.
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
    if prog.combine == "sample" and key is None:
        raise ValueError("combine='sample' draws keyed priorities: pass key=")
    return _run_local(csr, prog, "scalar", state0, frontier0,
                      max_iters=max_iters, mode=mode,
                      push_capacity=push_capacity, kernel_bb=kernel_bb,
                      return_stats=return_stats, trace=trace,
                      trace_len=trace_len, key=key)


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
      bitwise OR (:func:`offload.segment_or_rows` on a dense level, the
      gather fused in; :func:`offload.segment_or` on a push level).  The
      program is written
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
      have no kernel combine.  The structured combines are refused, as in
      the reference: sampling is batch-shaped already
      (:func:`sample_neighbors`) and label modes are one-shot.
    Returns the final state; ``return_stats`` / ``trace`` / ``trace_len`` as
    :func:`run`, the trace rows describing the shared union-frontier scan.
    """
    if prog.structured:
        raise NotImplementedError(
            "structured combines are not lane-batched: sampling is already "
            "batch-shaped (sample_neighbors), label modes are one-shot")
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
                           slack: Optional[float] = None,
                           n: Optional[int] = None, device=None) -> int:
    """Per-peer routing capacity for the compacted sparse push.

    While the engine is in the push regime the frontier holds at most
    ``switch_frac * n`` vertices, so with edges spread uniformly a shard sees
    about ``switch_frac * m`` active edges; ``slack`` covers degree skew.
    The local placement routes nothing: the service's route-byte model
    (``traffic.push_level_route_bytes``) prices its push levels at this
    capacity.  ``slack`` None takes the tuned ``engine.push_slack``
    (``repro_torch.tune``) for ``device``'s type at the scale of ``n``
    (global vertices) when the caller knows them.
    """
    slack = _tune.resolve("engine.push_slack", slack, n=n, device=device)
    return max(1, min(m, int(m * switch_frac * slack)))


# ---------------------------------------------------------------------------
# Distributed placement: one rank per shard over a launch.mesh.Mesh
# ---------------------------------------------------------------------------

def _owned_local(src: torch.Tensor, att) -> torch.Tensor:
    """int64 local offsets of owned sources (0 on padding edges)."""
    return torch.where(src >= 0, att.local(src.clamp(min=0)), 0).long()


def _active_edge_mask(src, frontier, att):
    """Per-shard mask of edges whose (owned) source is in the frontier."""
    return (src >= 0) & (frontier[_owned_local(src, att)] > 0)


def _compact_slots(valid: torch.Tensor, cap: int) -> torch.Tensor:
    """Positions of the True entries of ``valid``, in order, padded with
    -1 to ``cap`` (the first ``cap`` when there are more), by cumsum and
    scatter: no device read."""
    pos = torch.cumsum(valid, 0) - 1
    to = torch.where(valid & (pos < cap), pos, cap)
    slots = torch.full((cap + 1,), -1, dtype=torch.int64, device=valid.device)
    slots[to] = torch.arange(valid.shape[0], device=valid.device)
    return slots[:cap]


def _compact_active_edges(src, dst, val, active, cap: int):
    """Frontier-proportional payload: the edges ``active`` names,
    compacted into ``cap`` slots (padded with src = dst = -1, val = 0)."""
    slots = _compact_slots(active, cap)
    keep = slots >= 0
    safe = slots.clamp(min=0)
    return (torch.where(keep, src[safe], -1), torch.where(keep, dst[safe], -1),
            torch.where(keep, val[safe], 0.0))


def _push_step_shard(src, dst, val, msg, att, mesh, prog: VertexProgram,
                     capacity: int):
    """Scalar-lane push: the owner of src computes each contribution and
    the dst owner combines it (PIUMA remote atomic).  ``capacity`` is the
    per-peer routing budget: a level moves S * capacity slots."""
    lsrc = _owned_local(src, att)
    gidx = torch.where(src >= 0, dst, -1)
    if prog.structured:
        if prog.combine != "argmax_weighted":
            raise NotImplementedError(
                "distributed combine='sample' is queue-shaped work: run it "
                "through sample_neighbors instead")
        payload = offload.dma_gather(msg, lsrc, fill=-1).to(torch.int32)
        payload = torch.where(src >= 0, payload, -1)
        w = val if prog.edge_op == "mul" else torch.ones_like(val)
        return offload.remote_scatter_weighted_mode(
            att.per_shard, gidx, payload, w, att, mesh, capacity=capacity)
    ident = msg.new_full((), prog.ident)
    em = torch.where(src >= 0, offload.dma_gather(msg, lsrc, fill=prog.ident),
                     ident)
    ev = torch.where(src >= 0, _apply_edge(em, val, prog.edge_op), ident)
    acc = _acc_init(att.per_shard, prog, msg.dtype, msg.device)
    if prog.combine == "add":
        return offload.remote_scatter_add(acc, gidx, ev, att, mesh,
                                          capacity=capacity)
    return offload.remote_scatter_combine(acc, gidx, ev, att, mesh,
                                          combine=prog.combine,
                                          identity=prog.ident,
                                          capacity=capacity)


def _batched_push_step(att, mesh, prog: VertexProgram, packed: bool):
    """Lane-batched push: one routed item per active edge carries **all** B
    lanes (packed words, or a trailing valued lane dim) to the dst
    owner."""

    def push_step(csrc, cdst, cval, msg, cap):
        gidx = torch.where(csrc >= 0, cdst, -1)
        lsrc = torch.where(csrc >= 0, att.local(csrc.clamp(min=0)), -1)
        if packed:
            em = offload.dma_gather(msg, lsrc, fill=0)
            return offload.remote_scatter_or(att.per_shard, gidx, em, att,
                                             mesh, capacity=cap)
        em = offload.dma_gather(msg.T, lsrc, fill=prog.ident)   # (m, B)
        ev = _apply_edge(em, cval[:, None], prog.edge_op)
        ev = torch.where((csrc >= 0)[:, None], ev, em.new_full((), prog.ident))
        acc0 = msg.new_full((att.per_shard, msg.shape[0]), prog.ident)
        if prog.combine == "add":
            acc = offload.remote_scatter_add(acc0, gidx, ev, att, mesh,
                                             capacity=cap)
        else:
            acc = offload.remote_scatter_combine(
                acc0, gidx, ev, att, mesh, combine=prog.combine,
                identity=prog.ident, capacity=cap)
        return acc.T                                            # (B, per)

    return push_step


def _push_dispatch(push_step, src, dst, val, att, union, edge_cap: int,
                   m_fwd: int, compact: bool):
    """The compaction plumbing shared by every lane representation: when
    no shard's active-edge count overflows ``edge_cap`` (the level's
    reduced count says so, alike on every rank) the level routes a
    compacted edge list at that small capacity; an overflowing level falls
    back to full-capacity routing (the fallback counter's numerator)."""

    def push(msg, frontier, over: int):
        if not compact:
            return push_step(src, dst, val, msg, m_fwd), 0
        if over:
            return push_step(src, dst, val, msg, m_fwd), 1
        active = _active_edge_mask(src, union(frontier), att)
        csrc, cdst, cval = _compact_active_edges(src, dst, val, active,
                                                 edge_cap)
        return push_step(csrc, cdst, cval, msg, edge_cap), 0

    return push


def _pull_step_shard(own, remote, val, msg, att_in, att_out, mesh,
                     prog: VertexProgram, capacity: int, gather_mode: str):
    """Pull: the owner of the *output* vertex fetches messages from the
    input owners (fine-grained ``dgas_gather``, or the ``all_gather``
    baseline) and reduces locally."""
    gidx = torch.where(remote >= 0, remote, -1)
    local_own = torch.where(own >= 0, att_out.local(own.clamp(min=0)), -1)
    if prog.structured:
        if prog.combine != "argmax_weighted":
            raise NotImplementedError(
                "distributed combine='sample' is queue-shaped work: run it "
                "through sample_neighbors instead")
        payload = offload.dgas_gather(msg, gidx, att_in, mesh,
                                      capacity=capacity, fill=-1)
        w = val if prog.edge_op == "mul" else torch.ones_like(val)
        return offload.segment_weighted_mode(local_own,
                                             payload.to(torch.int32), w,
                                             att_out.per_shard)
    if gather_mode == "dgas":
        em = offload.dgas_gather(msg, gidx, att_in, mesh, capacity=capacity,
                                 fill=prog.ident)
    else:
        em = offload.all_gather_gather(msg, gidx, att_in, mesh,
                                       fill=prog.ident)
    ev = torch.where(own >= 0, _apply_edge(em, val, prog.edge_op),
                     em.new_full((), prog.ident))
    acc = _acc_init(att_out.per_shard, prog, msg.dtype, msg.device)
    if prog.combine == "add":
        return offload.dma_scatter_add(acc, local_own, ev)
    return _scatter_combine(acc, local_own, ev, prog.combine, prog.ident)


def _async_split(src, dst, val, att, mesh, prog: VertexProgram, lanes: str):
    """Plan the async placement's split push pass.  Every resident edge is
    **local** (destination owned by this rank: its contribution goes to the
    local accumulator at once) or **remote** (folded into the dense
    (S * per, ...) outbox at ``ATT.flat_slot``, delivered by the next
    ``offload.buffered_flush``).  A pass makes no collective.

    Returns ``(pass_, orient, merge, outbox_of)``: pass_(msg, outbox) ->
    (acc, outbox) in scatter layout (the outbox updated in place); orient
    — scatter layout to the update's lane layout; merge — the combine,
    elementwise; outbox_of(msg) — an identity-filled outbox for messages
    shaped like ``msg``."""
    per, me = att.per_shard, offload.my_shard(mesh)
    in_range = src >= 0
    lsrc = torch.where(in_range, att.local(src.clamp(min=0)), -1)
    d_safe = dst.clamp(min=0)
    is_local = in_range & (att.owner(d_safe) == me)
    lidx = torch.where(is_local, att.local(d_safe), -1)
    ridx = torch.where(in_range & ~is_local, att.flat_slot(d_safe), -1)

    if lanes == "packed":
        def pass_(msg, outbox):
            em = offload.dma_gather(msg, lsrc, fill=0)
            acc = offload.segment_or(lidx, em, per)
            outbox |= offload.segment_or(ridx, em, outbox.shape[0])
            return acc, outbox

        orient = lambda a: a
        merge = torch.bitwise_or
    else:
        def pass_(msg, outbox):
            flat = msg.T if lanes == "valued" else msg       # gather by row
            em = offload.dma_gather(flat, lsrc, fill=prog.ident)
            ev = _apply_edge(em, val if lanes == "scalar" else val[:, None],
                             prog.edge_op)
            mask = in_range if lanes == "scalar" else in_range[:, None]
            ev = torch.where(mask, ev, em.new_full((), prog.ident))
            acc = em.new_full((per,) + tuple(ev.shape[1:]), prog.ident)
            acc = _scatter_combine(acc, lidx, ev, prog.combine, prog.ident)
            outbox = _scatter_combine(outbox, ridx, ev, prog.combine, prog.ident)
            return acc, outbox

        orient = (lambda a: a.T) if lanes == "valued" else (lambda a: a)
        merge = {"add": torch.add, "min": torch.minimum,
                 "max": torch.maximum}[prog.combine]

    def outbox_of(msg):
        if lanes == "packed":
            return msg.new_zeros((att.n_shards * per,) + tuple(msg.shape[1:]))
        trail = (msg.shape[0],) if lanes == "valued" else ()
        return msg.new_full((att.n_shards * per,) + trail, prog.ident)

    return pass_, orient, merge, outbox_of


def reverse_graph(csr: CSR, att):
    """Shard the *transposed* edge list by destination owner (``att``, the
    vertex rule) for the distributed pull direction."""
    from .algorithms.distgraph import shard_graph
    return shard_graph(csr.transpose(), att.n_shards, row_att=att)[0]


def _level_counts(snapshots: list, taken: list) -> list:
    """Per level: whether it pushed (async: flushed) and fell back, and
    what it handed to the backend — the differences between the mesh's
    counts after consecutive level counts."""
    return [{"push": push, "fallback": fb,
             "collectives": b["collectives"] - a["collectives"],
             "bytes": {k: b["bytes"][k] - a["bytes"][k] for k in b["bytes"]}}
            for a, b, (push, fb) in zip(snapshots, snapshots[1:], taken)]


def _run_distributed(g, att, mesh, prog: VertexProgram, state0: Any,
                     frontier0: torch.Tensor, *, lanes: str, max_iters: int,
                     mode: str, switch_frac, push_edge_capacity, g_rev,
                     return_stats: bool, placement: str = "sync",
                     sync_interval: int = 1, trace_len: int = 0):
    """Shared distributed runner: plan this rank's ExecutionCore and run
    the single stepping loop.  Every rank calls it with its own rows of
    the state; every branch is taken on numbers all ranks share (the
    level's all-reduced counts), so the ranks meet in the same collectives.

    placement 'sync' is the per-level bulk-synchronous engine; 'async' the
    bounded-staleness variant: sync_interval-1 collective-free local
    micro-steps between global checks, each check one
    ``offload.buffered_flush`` and the level's count."""
    if placement not in ("sync", "async"):
        raise ValueError(
            f"placement must be 'sync' or 'async', got {placement!r}")
    if placement == "async":
        if prog.structured:
            raise NotImplementedError(
                "the async placement defers messages in a dense combine "
                "outbox: structured combines (argmax_weighted/sample) have "
                "no identity-mergeable buffer entry")
        if mode != "push":
            raise ValueError("the async placement paces the split "
                             "local/remote push pass: mode must be 'push'")
        if sync_interval < 1:
            raise ValueError(f"sync_interval must be >= 1, got {sync_interval}")
    if att.n_shards != mesh.size:
        raise ValueError(f"the ATT has {att.n_shards} shards, the mesh "
                         f"{mesh.size} ranks")
    from .algorithms.distgraph import local_shard
    dev = mesh.device
    shard = local_shard(g, mesh)
    src, dst, val = shard.src, shard.dst, shard.val
    switch_frac = _tune.resolve("engine.switch_frac", switch_frac,
                                n=att.n_global, device=dev)
    switch_count = max(1, int(att.n_global * switch_frac))
    m_fwd = shard.edges_per_shard
    if push_edge_capacity is None:
        edge_cap = frontier_edge_capacity(m_fwd, switch_frac, n=att.n_global,
                                          device=dev)
    else:
        edge_cap = int(push_edge_capacity)
    compact = mode != "pull" and 0 < edge_cap < m_fwd
    per = att.per_shard
    msg_of, update, union = _lane_ops(prog, lanes)
    deg = torch.zeros(per, dtype=torch.int64, device=dev).index_add_(
        0, _owned_local(src, att), (src >= 0).long())
    snapshots = []

    def count(f):
        act = union(f)
        edges = (deg * act).sum()
        over = (edges > edge_cap).long() if compact else torch.zeros_like(edges)
        c = offload.hierarchical_psum(torch.stack([act.sum(), edges, over]),
                                      mesh)
        snapshots.append(mesh.counts())
        return c

    state, frontier = state0, frontier0
    if placement == "async":
        # the carried state is (state, outbox): each level runs
        # sync_interval-1 collective-free split passes (pace), then one
        # checked step — a split pass, one buffered_flush delivering every
        # deferred remote contribution, and the count.  The outbox is
        # drained before every count, so alive == 0 means quiescence.
        pass_, orient, merge, outbox_of = _async_split(src, dst, val, att,
                                                       mesh, prog, lanes)

        def amsg(wrapped, f):
            st, box = wrapped
            return msg_of(st, f), box

        def astep(msg_box, f, counts, it_key):
            m, box = msg_box
            acc, box = pass_(m, box)
            arrived = offload.buffered_flush(box, mesh, combine=prog.combine)
            # 'pushes' counts flushes under the async placement
            return orient(merge(acc, arrived)), 1, 0

        def aupdate(wrapped, acc, f, it):
            st, _ = wrapped
            st, f = update(st, acc, f, it)
            return (st, box_id.clone()), f   # flushed: a fresh outbox

        def apace(wrapped, f, it):
            def micro(carry, step_it):
                st_, box_, f_ = carry
                acc_, box_ = pass_(msg_of(st_, f_), box_)
                st_, f_ = update(st_, orient(acc_), f_, step_it)
                return st_, box_, f_

            st, box = wrapped
            st, box, f = _scan_steps(micro, (st, box, f), sync_interval - 1,
                                     it)
            return (st, box), f, it + sync_interval - 1

        core = ExecutionCore(msg=amsg, step=astep, update=aupdate,
                             count=count,
                             pace=apace if sync_interval > 1 else None)
        box_id = outbox_of(msg_of(state, frontier))
        state = (state, box_id.clone())
    else:
        if lanes == "scalar":
            def push_step(s, d, v, msg, cap):
                return _push_step_shard(s, d, v, msg, att, mesh, prog, cap)
        else:
            push_step = _batched_push_step(att, mesh, prog,
                                           packed=lanes == "packed")
        push = _push_dispatch(push_step, src, dst, val, att, union, edge_cap,
                              m_fwd, compact)
        rev = None if g_rev is None else local_shard(g_rev, mesh)

        def step(msg, f, counts, it_key):
            if mode == "pull" or (mode == "auto" and counts[0] > switch_count):
                # g_rev rows: src = output vertex (owned here), dst = input
                return _pull_step_shard(rev.src, rev.dst, rev.val, msg, att,
                                        att, mesh, prog,
                                        capacity=rev.edges_per_shard,
                                        gather_mode="dgas"), 0, 0
            acc, fb = push(msg, f, counts[2])
            return acc, 1, fb

        core = ExecutionCore(msg=msg_of, step=step, update=update,
                             count=count)
    taken = []

    def step_taken(*a):
        acc, was_push, fb = core.step(*a)
        taken.append((was_push, fb))
        return acc, was_push, fb

    state, stats = _core_loop(dataclasses.replace(core, step=step_taken),
                              state, frontier, max_iters=max_iters,
                              trace_len=trace_len,
                              trace_flush=placement == "async")
    if placement == "async":
        state = state[0]   # drop the (drained) outbox
    if not return_stats:
        return state
    stats["levels"] = _level_counts(snapshots, taken)
    return state, stats


def run_distributed(g, att, mesh, prog: VertexProgram, state0: Any,
                    frontier0: torch.Tensor, *, max_iters: int, g_rev=None,
                    mode: str = "push", switch_frac: Optional[float] = None,
                    push_edge_capacity: Optional[int] = None,
                    return_stats: bool = False, placement: str = "sync",
                    sync_interval: Optional[int] = None, trace: bool = False,
                    trace_len: Optional[int] = None, axis=None):
    """Distributed loop on one rank of ``mesh``: the (scalar lanes,
    distributed placement) point of the grid.  Every rank calls it with
    the same arguments except ``state0`` / ``frontier0``, which are its own
    (per_shard,) rows under ``att``; ``g`` (and ``g_rev``) is the stacked
    ``ShardedGraph`` or this rank's ``GraphShard``, sharded by ``att``.

    mode: 'push' (every level scatters via remote atomics), 'pull'
      (requires `g_rev`; every level gathers via dgas), or 'auto' (push
      while the all-reduced frontier is at most `switch_frac * n`, pull
      above it).
    switch_frac: the 'auto' switch threshold (and the capacity
      derivation's frontier bound); None resolves the tuned value for the
      mesh device's type and the graph's scale (``repro_torch.tune``).
    placement: 'sync' (one global reduction per level) or 'async'
      (bounded-staleness pacing: `sync_interval` local micro-steps per
      global check, cross-shard messages deferred into a dense combine
      outbox flushed once per check; requires mode='push' and a
      non-structured combine).
    sync_interval: micro-steps per global check under 'async' (default 8).
    push_edge_capacity: per-peer routing capacity of the *compacted* push
      step (None derives `frontier_edge_capacity(m, switch_frac)`; 0
      disables compaction).  A level whose active edges overflow it on any
      shard routes at full capacity and counts as a fallback.
    return_stats: also return {'iters', 'pushes', 'pulls', 'fallbacks'}
      (ints, the same on every rank) and, the port's own, 'levels': per
      level whether it pushed ('push'; under 'async': flushed) and fell
      back ('fallback'), and the collectives and bytes per kind this rank
      handed to the backend (the step's routes, the program's reductions,
      the count).
    trace: with return_stats, the per-level trace (``stats['trace']``,
      (trace_len, 4) int32, the same on every rank); under 'async' each
      row is one global check and the flush column fires.
    axis: the mesh axis the shards lie along (``Mesh.over``: None is the
      first axis, a tuple of axes their flattened world).
    Returns this rank's final state (per_shard rows).
    """
    mesh = mesh.over(axis)
    if mode not in ("auto", "push", "pull"):
        raise ValueError(f"mode must be 'auto', 'push' or 'pull', got {mode!r}")
    if prog.combine == "or":
        raise ValueError("combine='or' is the batched bitwise combine: run it "
                         "through run_batched_distributed")
    if mode in ("pull", "auto") and g_rev is None:
        raise ValueError(f"mode={mode!r} needs g_rev (see reverse_graph)")
    if sync_interval is None:
        sync_interval = 8 if placement == "async" else 1
    return _run_distributed(g, att, mesh, prog, state0, frontier0,
                            lanes="scalar", max_iters=max_iters, mode=mode,
                            switch_frac=switch_frac,
                            push_edge_capacity=push_edge_capacity,
                            g_rev=g_rev, return_stats=return_stats,
                            placement=placement,
                            sync_interval=int(sync_interval),
                            trace_len=_trace_len_of(trace, trace_len,
                                                    max_iters, return_stats))


def run_batched_distributed(g, att, mesh, prog: VertexProgram, state0: Any,
                            frontier0: torch.Tensor, *, max_iters: int,
                            switch_frac: Optional[float] = None,
                            push_edge_capacity: Optional[int] = None,
                            return_stats: bool = False,
                            placement: str = "sync",
                            sync_interval: Optional[int] = None,
                            trace: bool = False,
                            trace_len: Optional[int] = None, axis=None):
    """Distributed batched loop: B concurrent traversals, one push
    pipeline, on one rank of ``mesh``.

    * packed (``combine='or'``): frontier0 is this rank's (per, W) int32
      words; the remote combine is :func:`offload.remote_scatter_or` at
      the dst owner (the ``segment_or`` kernel on the card).
    * valued: frontier0 is (B, per) int32, state leaves (B, ...), and the
      single-source msg_fn / update_fn are vmapped over the lanes (a
      reduction inside the program, such as SSSP's global bucket minimum,
      is one all-reduce of every lane).

    Every level pushes with the active-edge compaction driven by the
    union frontier, so one compacted exchange carries all B lanes.  Stats,
    trace, placement and axis as :func:`run_distributed` ('pulls' is
    always 0).  Returns this rank's final state.
    """
    mesh = mesh.over(axis)
    if prog.structured:
        raise NotImplementedError(
            "structured combines are not lane-batched: sampling is already "
            "batch-shaped (sample_neighbors)")
    packed = prog.combine == "or"
    if sync_interval is None:
        sync_interval = 8 if placement == "async" else 1
    return _run_distributed(g, att, mesh, prog, state0, frontier0,
                            lanes="packed" if packed else "valued",
                            max_iters=max_iters, mode="push",
                            switch_frac=switch_frac,
                            push_edge_capacity=push_edge_capacity,
                            g_rev=None, return_stats=return_stats,
                            placement=placement,
                            sync_interval=int(sync_interval),
                            trace_len=_trace_len_of(trace, trace_len,
                                                    max_iters, return_stats))


def spmv_pass(g, x_local: torch.Tensor, x_att, row_att, mesh, *,
              mode: str = "dgas", axis=None) -> torch.Tensor:
    """One distributed pull step == y = A @ x on this rank (rows per
    ``row_att``, x per ``x_att``): this rank's (per_shard,) rows of y."""
    mesh = mesh.over(axis)
    from .algorithms.distgraph import local_shard
    prog = VertexProgram(edge_op="mul", combine="add",
                         msg_fn=lambda s, f: s, update_fn=None)
    shard = local_shard(g, mesh)
    return _pull_step_shard(shard.src, shard.dst, shard.val, x_local, x_att,
                            row_att, mesh, prog,
                            capacity=shard.edges_per_shard, gather_mode=mode)


# ---------------------------------------------------------------------------
# Queue-driven programs (the second program family: work entries, not bits)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QueueProgram:
    """An algorithm whose unit of work is a queue entry, not a frontier bit.

    step_fn: (operands, items, payload, state, it, key)
             -> (items, payload, state, out)
      items:   (cap,) int32 entries, -1 = empty slot; setting an entry to
               -1 retires it (the runner re-compacts before balancing).
      payload: tensor (or tuple / list / dict of tensors) of (cap, ...)
               companion data aligned with the items; it migrates with
               them through the balancer.
      key:     the iteration's draw key, ``fold_in(run key, it)``, the same
               on every rank: a program keys each draw on its own entry
               (a walker on its id), so a draw does not depend on the rank
               the entry sits on or on the balancing cadence.
      out:     a tensor or tuple of tensors to stack per iteration.
    """

    step_fn: Callable


def run_queue(mesh, prog: QueueProgram, items0: torch.Tensor, payload0: Any,
              operands: Any, *, n_iters: int, axis=None, key=None,
              state0: Any = (), sync_interval: int = 1):
    """Queue-driven distributed runner, on one rank of ``mesh``.

    Every rank calls it with its own queue: ``items0`` (cap,) int32 (-1 =
    empty slot, the same cap on every rank), ``payload0`` riding with the
    items, ``operands`` (this rank's blocks of the sharded arrays every
    step reads) and ``state0``.  Each iteration, driven by the engine's
    fixed-length :func:`_scan_steps`, compacts the live entries to a
    stable prefix (:func:`_compact_slots`, the push step's compaction),
    balances them across the ranks every ``sync_interval``-th iteration
    (:func:`offload.queue_balance`, the body's only collective: the ranks
    run at their own pace in between) and calls ``step_fn`` with the key
    ``fold_in(key, it)``.  ``key`` None is key 0.

    Returns (state, outs): this rank's final state and each ``out`` leaf
    stacked (n_iters, ...).
    """
    mesh = mesh.over(axis)
    if sync_interval < 1:
        raise ValueError(f"sync_interval must be >= 1, got {sync_interval}")
    dev = items0.device
    k = as_key(0 if key is None else key, dev)
    cap = int(items0.shape[0])
    leaves, rebuild = offload._leaves(payload0)
    outs = []

    def body(carry, it):
        items, leaves_, state = carry
        # retired entries may sit anywhere in the buffer: compact the live
        # ones to a stable prefix before balancing
        slots = _compact_slots(items >= 0, cap)
        safe = slots.clamp(min=0)
        items = torch.where(slots >= 0, items[safe], -1).to(torch.int32)
        leaves_ = [x[safe] for x in leaves_]
        q = offload.QueueState(items, (items >= 0).sum().to(torch.int32))
        if it % sync_interval == 0:
            if leaves_:
                q, leaves_ = offload.queue_balance(q, mesh, list(leaves_))
            else:
                q = offload.queue_balance(q, mesh)
        items, payload, state, out = prog.step_fn(
            operands, q.items, rebuild(leaves_), state, it, fold_in(k, it))
        outs.append(out)
        return items, offload._leaves(payload)[0], state

    _, _, state = _scan_steps(body, (items0.to(torch.int32), list(leaves),
                                     state0), n_iters, 0)
    if not outs:
        return state, ()
    if isinstance(outs[0], torch.Tensor):
        return state, torch.stack(outs)
    return state, type(outs[0])(torch.stack(o) for o in zip(*outs))


# ---------------------------------------------------------------------------
# Multi-level pipeline (hierarchy of coarsened graphs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """A chain of coarsening maps from a :func:`run_multilevel` run.

    ``maps[l]`` is the (n_l,) int32 map from level-l vertex to its
    level-(l+1) supernode: the level-(l+1) graph is the level-l graph
    contracted along ``maps[l]``.
    """

    maps: tuple

    @property
    def n_levels(self) -> int:
        return len(self.maps)

    def project(self, top: torch.Tensor) -> torch.Tensor:
        """Pull a per-vertex array at the *top* (coarsest) level down to
        level 0 by composing the maps: out[v] = top[maps[-1][...
        maps[0][v]]]."""
        x = top
        for m in reversed(self.maps):
            x = x[m.long()]
        return x


def run_multilevel(csr: CSR, level_fn: Callable, contract_fn: Callable,
                   score_fn: Callable, *, max_levels: int = 10,
                   tol: float = 1e-4):
    """Generic cluster-then-contract level pipeline (multi-level Louvain's
    loop shape, program-agnostic).

    Per level: ``level_fn(g, level) -> (n_l,) assignment``, ``score_fn(g,
    assign) -> float`` (or a 0-d tensor) scores the raw assignment, and —
    only if the level is accepted — ``contract_fn(g, assign) ->
    (coarse_g, renumber)`` collapses it.  A level is **accepted only if it
    improves the score by more than ``tol``** over the previous accepted
    level (level 0 must beat the singleton baseline ``score_fn(csr,
    arange)``); the first non-improving level is discarded, without paying
    for its contraction, and the loop stops, so the returned scores
    increase strictly.  Also stops when a level no longer shrinks the
    graph.  Host-driven: each level's shapes depend on the previous level's
    readback, so reading each score to the host is the control flow.

    Returns ``(labels0, hierarchy, scores)``: the level-0 projection of the
    final clustering, the :class:`Hierarchy` of accepted maps, and the
    accepted levels' scores.
    """
    g = csr
    maps, scores = [], []
    q_prev = float(score_fn(g, torch.arange(g.n_rows, dtype=torch.int32,
                                            device=g.device)))
    for level in range(max_levels):
        assign = level_fn(g, level)
        q = float(score_fn(g, assign))
        if not math.isfinite(q) or q <= q_prev + tol:
            break
        coarse, renumber = contract_fn(g, assign)
        maps.append(renumber)
        scores.append(q)
        q_prev = q
        no_shrink = coarse.n_rows >= g.n_rows
        g = coarse
        if no_shrink:
            break
    hier = Hierarchy(tuple(maps))
    n_top = g.n_rows if maps else csr.n_rows
    labels0 = hier.project(torch.arange(n_top, dtype=torch.int32,
                                        device=csr.device))
    return labels0, hier, scores
