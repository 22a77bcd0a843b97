"""Offload engines (counterpart of ``repro.core.offload``): the in-node
DMA gather, scatter-add, the lane-word OR combine and the structured
segment combines; and, for the distributed placement, the owner-routed
remote engines and the collective engine over a ``launch.mesh.Mesh``.

Remote access is owner-routed: requests travel to the owner shard (by the
ATT of ``core.dgas``), the owner performs the gather or the commutative
update locally, and only the requested or accepted words cross between
ranks, in one fixed-capacity ``all_to_all`` per plane (:func:`_route`).
Every collective of the port is a ``Mesh`` method called from this module
(or from ``launch/mesh.py`` itself, or ``distributed/routed.py``'s
autograd wrappers of them), so the address-translation layer stays the
one place where data crosses shards.  A request that overflows a peer's
capacity is dropped and answers the fill value, as in the reference,
which drops it silently; the port counts it on the mesh
(``Mesh.dropped``).  A :class:`Route` keeps an exchange's slots, so rows
can travel along them again (:func:`send_along`, :func:`reply_along`):
the autograd exchanges send their gradients back that way.  The work queue engine
(:func:`queue_balance`) routes queued items through the same
:func:`_route`.  Routed helpers take the 1-D mesh a call runs on; a
caller that holds a multi-axis mesh picks it with ``Mesh.over(axis)`` (a
tuple of axes is their flattened world).

Sums that decide a label (the weighted label mode's per-(destination,
label) runs, ``graph.contract``'s parallel coarse edges, the Louvain gain
gate's column sums) are taken in stream order, as the reference's
``jax.ops.segment_sum`` takes them on the CPU: :func:`run_sum` and
:func:`segment_weighted_mode` launch ``csrc/segment_mode.cu`` on the card,
where a scatter-add's atomics would add in a different order each run.
Totals over a whole array go through :func:`tree_sum`, one fixed pairwise
order on every device.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["LABEL_PAD", "dma_gather", "dma_scatter_add", "segment_or",
           "segment_argmax", "run_starts", "segment_weighted_mode",
           "compact_labels", "run_sum", "segment_sum_ordered", "tree_sum",
           "axis_size", "my_shard", "Route", "dgas_requests", "send_along",
           "reply_along", "segment_sum_rows", "dgas_gather",
           "remote_scatter_add",
           "remote_scatter_combine", "remote_scatter_or",
           "remote_scatter_weighted_mode", "buffered_flush",
           "all_gather_gather", "QueueState", "queue_make",
           "queue_balance", "hierarchical_psum", "barrier", "prefix_scan",
           "global_min"]

# payload sentinel that sorts after every real label / vertex id
LABEL_PAD = 2 ** 30


def dma_gather(table: torch.Tensor, idx: torch.Tensor, *,
               fill: float = 0.0) -> torch.Tensor:
    """Gather rows/elements; out-of-range indices return `fill`."""
    valid = (idx >= 0) & (idx < table.shape[0])
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    out = table[safe]
    mask = valid.reshape(valid.shape + (1,) * (out.dim() - valid.dim()))
    return torch.where(mask, out, out.new_full((), fill))


def dma_scatter_add(dest: torch.Tensor, idx: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """Scatter-add with padding indices (<0 or >=n) dropped.  Updates
    ``dest`` in place (the reference returns a new array; callers pass a
    fresh buffer, so the copy would be waste) and returns it."""
    valid = (idx >= 0) & (idx < dest.shape[0])
    safe = torch.where(valid, idx, torch.zeros_like(idx)).reshape(-1)
    mask = valid.reshape(valid.shape + (1,) * (vals.dim() - valid.dim()))
    src = torch.where(mask, vals, vals.new_zeros(()))
    src = src.to(dest.dtype).reshape((-1,) + tuple(dest.shape[1:]))
    return dest.index_add_(0, safe, src)


def segment_or(idx: torch.Tensor, words: torch.Tensor, n: int, *,
               presorted: bool = False) -> torch.Tensor:
    """Per-destination bitwise OR of packed lane words (MS-BFS's combine).

    ``idx`` (m,) int destinations (out-of-range ignored), ``words`` (m, W)
    int32 bit-packed lane payloads.  Returns (n, W) int32 with out[v] = OR
    of all words whose idx == v (0 where no items land).  CPU tensors take
    the plain version, CUDA tensors the kernel of ``csrc/segment_or.cu``
    (atomic OR, one per run of equal ids in a warp).  ``presorted`` (the
    stream is sorted by destination) is the reference's hint, which the
    port does not need: OR does not depend on order, and the kernel merges
    equal ids in a warp whatever the order."""
    from ..kernels import segment_or as _so
    return _so.segment_or_kernel_call(idx, words, n)


# ---------------------------------------------------------------------------
# Structured segment combines (the engine's argmax / sample reductions)
# ---------------------------------------------------------------------------

def segment_argmax(idx: torch.Tensor, score: torch.Tensor,
                   payload: torch.Tensor, n: int):
    """Per-destination (score, payload)-packed segment max.

    For each destination v: best[v] = max score over items with idx == v,
    and pick[v] = the payload of a maximizing item, ties toward the
    *smaller* payload.  Items with idx outside [0, n) or score == -inf are
    ignored; destinations with no items get (-inf, -1).  A two-plane
    scatter (max of the scores, then min of the payloads that reach it):
    neither depends on the order of the items, so the result is the same
    on every device."""
    valid = (idx >= 0) & (idx < n)
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    neg = score.new_full((), float("-inf"))
    s = torch.where(valid, score, neg)
    best = torch.full((n,), float("-inf"), dtype=score.dtype,
                      device=score.device).scatter_reduce_(
        0, safe, s, "amax", include_self=True)
    is_best = valid & (s == best[safe]) & (s > neg)
    pad = torch.full((), LABEL_PAD, dtype=torch.int32, device=score.device)
    cand = torch.where(is_best, payload.to(torch.int32), pad)
    pick = torch.full((n,), LABEL_PAD, dtype=torch.int32,
                      device=score.device).scatter_reduce_(
        0, safe, cand, "amin", include_self=True)
    return best, torch.where(pick == LABEL_PAD, -1, pick)


def run_starts(*sorted_keys: torch.Tensor):
    """Run detection over a lex-sorted key stream (nonempty): returns
    (is_start (m,) bool, run_id (m,) int64 — the exclusive count of
    starts).  A run is a maximal stretch where every key matches its
    predecessor."""
    neq = None
    for k in sorted_keys:
        d = k[1:] != k[:-1]
        neq = d if neq is None else (neq | d)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool,
                                     device=sorted_keys[0].device), neq])
    return is_start, torch.cumsum(is_start.long(), 0) - 1


def segment_weighted_mode(idx: torch.Tensor, labels: torch.Tensor,
                          weights: torch.Tensor, n: int):
    """Per-destination weighted mode: argmax_l sum(weights | idx==v,
    labels==l).

    Returns (best_w (n,) f32, best_label (n,) int32): the winning label's
    total weight and the label itself, ties toward the smaller label.  Items
    with idx outside [0, n) or labels < 0 are ignored; destinations with no
    items get (-inf, -1).  The items are sorted by the packed key
    ``destination << 32 | label`` with one stable sort, so each
    (destination, label) run keeps the stream's order; then each run is
    summed in that order and the largest sum picked per destination: the
    plain version on CPU tensors (in-order run sums and
    :func:`segment_argmax`), the ``segment_mode`` kernel on CUDA tensors.
    Both add as the reference does on the CPU, so the bits agree."""
    from ..kernels import segment_mode as _sm
    dev = weights.device
    if idx.shape[0] == 0:
        return (torch.full((n,), float("-inf"), device=dev),
                torch.full((n,), -1, dtype=torch.int32, device=dev))
    valid = (idx >= 0) & (idx < n) & (labels >= 0)
    si = torch.where(valid, idx.long(), n)
    sl = torch.where(valid, labels.long(), LABEL_PAD)
    key, order = torch.sort((si << 32) | sl, stable=True)
    sw = torch.where(valid[order], weights[order].to(torch.float32), 0.0)
    return _sm.segment_mode_kernel_call(key >> 32, key & 0xFFFFFFFF, sw, n)


def compact_labels(labels: torch.Tensor):
    """Renumber arbitrary int labels into dense ids [0, n_c),
    order-preserving: sort, mark run starts, prefix-sum the starts.
    Returns (dense (n,) int32, n_c () int32 on the labels' device); the
    smallest original label maps to 0."""
    n = int(labels.shape[0])
    dev = labels.device
    if n == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    sl, order = torch.sort(labels, stable=True)
    _, run_id = run_starts(sl)
    rank = run_id.to(torch.int32)
    dense = torch.empty(n, dtype=torch.int32, device=dev)
    dense[order] = rank
    return dense, rank[-1] + 1


def run_sum(idx: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) per-id sums over a stream sorted by ``idx``, each id's weights
    added one after the other in stream order from 0 — the reference's
    ``jax.ops.segment_sum`` as the CPU runs it — in f32, or in f64 for
    float64 weights; ids outside [0, n) ignored.  CPU tensors take the
    plain version, CUDA tensors the ``run_sum`` kernel of
    ``csrc/segment_mode.cu``."""
    from ..kernels import segment_mode as _sm
    return _sm.run_sum_kernel_call(idx, w, n)


def segment_sum_ordered(vals: torch.Tensor, seg: torch.Tensor,
                        n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(vals, seg, n)`` with each segment added in item
    order, on any device: a stable sort by ``seg`` (which keeps the items'
    order within a segment), then :func:`run_sum`."""
    s, order = torch.sort(seg, stable=True)
    return run_sum(s, vals[order], n)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` as a 0-d tensor in one fixed pairwise order: padded
    with zeros to a power of two, then halved by adding its two halves
    until one value is left.  Each level is elementwise, so the bits are
    the same on every device (``torch.sum``'s order differs between the
    CPU and the card)."""
    x = x.reshape(-1)
    size = 1 << max(0, (x.numel() - 1).bit_length())
    x = torch.cat([x, x.new_zeros(size - x.numel())])
    while x.numel() > 1:
        h = x.numel() // 2
        x = x[:h] + x[h:]
    return x[0]


# ---------------------------------------------------------------------------
# Axis helpers: a rank's view of the 1-D mesh a call runs on
# ---------------------------------------------------------------------------

def axis_size(mesh) -> int:
    return mesh.size


def my_shard(mesh) -> int:
    """This rank's linear shard index."""
    return mesh.rank


def _all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
    """all_to_all over the leading axis (size * k rows: chunk p to rank p)."""
    return mesh.all_to_all(x)


# ---------------------------------------------------------------------------
# Owner routing (shared by dgas_gather and the remote_scatter_* engines)
# ---------------------------------------------------------------------------

def _owner_slots(dest: torch.Tensor, n_shards: int, capacity: int):
    """Assign each item a slot in its destination bucket: the stable sort
    by owner, the item's position within its bucket.

    Returns (flat, valid): flat = dest * capacity + slot for valid items
    (0 otherwise), valid = slot < capacity and 0 <= dest < n_shards.  The
    reference's order, so overflowing items drop alike."""
    n = dest.shape[0]
    sorted_dest, order = torch.sort(dest, stable=True)
    starts = torch.searchsorted(sorted_dest, torch.arange(
        n_shards, dtype=dest.dtype, device=dest.device))
    pos_sorted = torch.arange(n, device=dest.device) - \
        starts[sorted_dest.clamp(0, n_shards - 1).long()]
    slot = torch.empty(n, dtype=torch.int64, device=dest.device)
    slot[order] = pos_sorted
    valid = (slot < capacity) & (dest >= 0) & (dest < n_shards)
    flat = torch.where(valid, dest.long() * capacity + slot, 0)
    return flat.to(torch.int32), valid


def _route(payload: tuple, dest: torch.Tensor, mesh, capacity: int):
    """Send each payload row to shard ``dest[i]`` (fixed per-peer
    capacity): one ``all_to_all`` per payload plane and one for the int8
    validity plane.

    Returns (recv, recv_valid, flat, valid): recv — the planes with leading
    dim S * capacity, grouped by source rank; recv_valid (S * capacity,)
    bool; flat, valid — the sender's slot bookkeeping for :func:`_reply`.
    Items bound for a shard in range that find its bucket full are counted
    on the mesh as dropped.
    Each slot holds at most one item, so the items are stored, not added
    into a zeroed buffer as the reference adds them; a float -0.0 is routed
    as +0.0, the value the reference's add gives."""
    S = axis_size(mesh)
    flat, valid = _owner_slots(dest, S, capacity)
    mesh.add_dropped(((dest >= 0) & (dest < S) & ~valid).sum())
    # invalid items land in a spare slot past the end, dropped
    to = torch.where(valid, flat.long(), S * capacity)

    def store(x):
        if x.is_floating_point():
            x = x + 0.0
        buf = x.new_zeros((S * capacity + 1,) + tuple(x.shape[1:]))
        buf[to] = x
        return buf[:-1]

    sendv = store(valid.to(torch.int8))
    recv = tuple(_all_to_all(store(x), mesh) for x in payload)
    recvv = _all_to_all(sendv, mesh).bool()
    return recv, recvv, flat, valid


def _reply(reply: torch.Tensor, flat: torch.Tensor, valid: torch.Tensor,
           mesh, fill=0) -> torch.Tensor:
    """Return per-request answers computed at the owner to the
    requesters (one ``all_to_all``)."""
    back = _all_to_all(reply, mesh)
    # invalid requests read a fill row past the end (there is always one,
    # even at capacity 0)
    back = torch.cat([back, back.new_full((1,) + tuple(back.shape[1:]),
                                          fill)])
    return back[torch.where(valid, flat.long(), back.shape[0] - 1)]


def _routed_ids(gidx: torch.Tensor, att, *, mask_owner: bool):
    """(owner, local index) of each global id; the local index of an id
    outside [0, n_global) is -1, so its owner answers nothing.  Its owner
    is -1 (never routed) with ``mask_owner``, else the rule's owner of the
    id as it is, as the reference computes each (such a request still
    takes a slot of that owner's bucket)."""
    in_range = (gidx >= 0) & (gidx < att.n_global)
    local = torch.where(in_range, att.local(gidx), -1).to(torch.int32)
    owner = att.owner(gidx)
    if mask_owner:
        owner = torch.where(in_range, owner, -1)
    return owner.to(torch.int32), local


def _capacity(capacity, n: int, S: int) -> int:
    return capacity if capacity is not None else min(n, 2 * (-(-n // S)))


# ---------------------------------------------------------------------------
# DGAS remote access primitives
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Route:
    """The slots of one routed exchange, kept to send rows along them
    again (index tensors only): the sender's ``flat`` (m,) slot of each
    request and ``valid`` (m,) whether it found one, and the owner's
    ``local`` (S * capacity,) int32, the local id each received slot asks
    for, -1 where the slot is empty."""

    flat: torch.Tensor
    valid: torch.Tensor
    local: torch.Tensor


def _send(rows: torch.Tensor, flat: torch.Tensor, valid: torch.Tensor,
          slots: int, mesh, fill=0) -> torch.Tensor:
    """Each request's row into its slot of a (slots, ...) buffer of
    ``fill`` (a request without a slot into a spare one past the end,
    dropped), through one ``all_to_all``."""
    to = torch.where(valid, flat.long(), slots)
    buf = rows.new_full((slots + 1,) + tuple(rows.shape[1:]), fill)
    buf[to] = rows
    return _all_to_all(buf[:-1], mesh)


def dgas_requests(gidx: torch.Tensor, att, mesh, *, capacity=None,
                  payload: tuple = ()):
    """Route each request (global id ``gidx[i]``, with its rows of each
    payload tensor) to the id's owner, in the slots :func:`dgas_gather`
    gives it (the reference's order, so overflowing requests drop alike),
    one ``all_to_all`` per plane.  The local-id plane carries the slots'
    validity (-1 where a slot is empty), so there is no validity plane.
    capacity: the most requests any one peer pair exchanges (default 2 *
    ceil(m / S)).  Returns (Route, the payload planes as received, (S *
    capacity, ...) each, grouped by source rank, 0 in the empty slots)."""
    S = axis_size(mesh)
    C = _capacity(capacity, gidx.shape[0], S)
    owner, local_idx = _routed_ids(gidx, att, mask_owner=False)
    flat, valid = _owner_slots(owner, S, C)
    mesh.add_dropped(((owner >= 0) & (owner < S) & ~valid).sum())
    local = _send(local_idx, flat, valid, S * C, mesh, fill=-1)
    return (Route(flat, valid, local),
            tuple(_send(x, flat, valid, S * C, mesh) for x in payload))


def send_along(rows: torch.Tensor, route: Route, mesh) -> torch.Tensor:
    """Requester-side rows, one per request, to the owners along the
    route's slots: (S * capacity, ...) rows aligned with ``route.local``,
    0 in the empty slots (one ``all_to_all``)."""
    return _send(rows, route.flat, route.valid, route.local.shape[0], mesh)


def reply_along(rows: torch.Tensor, route: Route, mesh,
                fill=0) -> torch.Tensor:
    """Owner-side rows, one per slot of ``route.local``, back to the
    requesters: one row per request, ``fill`` where a request found no
    slot (one ``all_to_all``)."""
    return _reply(rows, route.flat, route.valid, mesh, fill=fill)


def segment_sum_rows(idx: torch.Tensor, rows: torch.Tensor,
                     n: int) -> torch.Tensor:
    """The owner-side update of a routed scatter-add through B4: (n, ...)
    float32, out[i] the sum of the rows whose idx is i; ids outside [0, n),
    such as the -1 of an empty slot, dropped.  A ``SegmentPlan`` over idx,
    then B4 (``kernels.ops.segment_sum_csr``) on the rows in its order:
    the plain version on CPU tensors, the kernel on CUDA tensors (or it
    raises)."""
    from ..kernels import ops
    from ..kernels.segment_sum import SegmentPlan
    plan = SegmentPlan(idx, n)
    flat = rows.reshape(rows.shape[0], -1)
    out = ops.segment_sum_csr(flat, plan.offsets, plan.perm)
    return out.reshape((n,) + tuple(rows.shape[1:]))


def dgas_gather(local: torch.Tensor, gidx: torch.Tensor, att, mesh, *,
                capacity=None, fill: float = 0.0) -> torch.Tensor:
    """PIUMA fine-grained remote gather across the DGAS.

    Each rank holds ``local`` (its rows of the global array, per ``att``);
    ``gidx`` are *global* ids to fetch.  Only the index requests and the
    fetched elements cross between ranks.  capacity: the most requests any
    one peer pair exchanges (default 2 * ceil(n / S)); overflowing requests
    return ``fill``."""
    C = _capacity(capacity, gidx.shape[0], axis_size(mesh))
    owner, local_idx = _routed_ids(gidx, att, mask_owner=False)
    (recv,), recvv, flat, valid = _route((local_idx,), owner, mesh, C)
    answers = dma_gather(local, torch.where(recvv, recv, -1), fill=fill)
    return _reply(answers, flat, valid, mesh, fill=fill)


def remote_scatter_add(local: torch.Tensor, gidx: torch.Tensor,
                       vals: torch.Tensor, att, mesh, *, capacity=None,
                       ordered: bool = False) -> torch.Tensor:
    """PIUMA remote atomic add, executed at the owner: (local index, value)
    pairs are routed to the owning rank, which applies one fused scatter
    add into ``local`` (updated in place and returned).

    ``ordered`` (1-D ``vals``): the owner adds each index's arrivals one
    after the other in arrival order — by source rank, then in each
    sender's order — from 0 (:func:`segment_sum_ordered`, the ``run_sum``
    kernel on the card) and adds that sum into ``local`` (pass zeros to
    get the sum itself).  Under a contiguous rule and source-sorted
    senders that is the ascending-source order a local in-order sum
    takes; a scatter-add's atomics follow no order on the card.  The
    meshed GNNs' owners sum (m, d) rows with B4 instead
    (:func:`segment_sum_rows`, through ``distributed.routed``)."""
    C = _capacity(capacity, gidx.shape[0], axis_size(mesh))
    owner, local_idx = _routed_ids(gidx, att, mask_owner=False)
    (ridx, rvals), recvv, _, _ = _route((local_idx, vals), owner, mesh, C)
    idx = torch.where(recvv, ridx, -1)
    if not ordered:
        return dma_scatter_add(local, idx, rvals)
    ok = (idx >= 0) & (idx < local.shape[0])
    sums = segment_sum_ordered(rvals, torch.where(ok, idx, local.shape[0]),
                               local.shape[0])
    return local.add_(sums.to(local.dtype))


def remote_scatter_combine(local: torch.Tensor, gidx: torch.Tensor,
                           vals: torch.Tensor, att, mesh, *, combine: str,
                           identity, capacity=None) -> torch.Tensor:
    """Remote atomic min / max at the owner (same routing as
    :func:`remote_scatter_add`); ``vals`` may carry trailing lane dims.
    ``local`` is updated in place and returned."""
    if combine not in ("min", "max"):
        raise ValueError(f"combine must be 'min' or 'max', got {combine!r}")
    C = _capacity(capacity, gidx.shape[0], axis_size(mesh))
    owner, local_idx = _routed_ids(gidx, att, mask_owner=False)
    (ridx, rvals), recvv, _, _ = _route((local_idx, vals), owner, mesh, C)
    ok = recvv & (ridx >= 0) & (ridx < local.shape[0])
    mask = ok.reshape((-1,) + (1,) * (rvals.dim() - 1))
    masked = torch.where(mask, rvals.to(local.dtype),
                         local.new_full((), identity))
    safe = torch.where(ok, ridx, 0).long()
    safe = safe.reshape((-1,) + (1,) * (rvals.dim() - 1)).expand_as(masked)
    return local.scatter_reduce_(0, safe, masked,
                                 "amin" if combine == "min" else "amax",
                                 include_self=True)


def remote_scatter_or(per_shard_n: int, gidx: torch.Tensor,
                      words: torch.Tensor, att, mesh, *,
                      capacity=None) -> torch.Tensor:
    """Remote atomic OR of bit-packed int32 lane words at the owner: each
    rank contributes (global vertex, (W,) words) pairs; the owner reduces
    its arrivals with :func:`segment_or` (the ``segment_or`` kernel on the
    card).  One routed item carries all B lanes.  Returns the
    (per_shard_n, W) int32 OR-accumulator."""
    C = _capacity(capacity, gidx.shape[0], axis_size(mesh))
    owner, local_idx = _routed_ids(gidx, att, mask_owner=True)
    (ridx, rwords), recvv, _, _ = _route(
        (local_idx, words.to(torch.int32)), owner, mesh, C)
    return segment_or(torch.where(recvv, ridx, -1), rwords, per_shard_n)


def remote_scatter_weighted_mode(per_shard_n: int, gidx: torch.Tensor,
                                 labels: torch.Tensor, weights: torch.Tensor,
                                 att, mesh, *, capacity=None):
    """Remote structured combine: the weighted label mode at the owner.
    (global vertex, label, weight) votes are routed raw, and the owner's
    :func:`segment_weighted_mode` (the ``segment_mode`` kernel on the card)
    sums each (vertex, label) pair over every contributing rank before
    taking the argmax.  Arrivals are grouped by source rank in each
    sender's order, so under a contiguous rule a run adds in ascending
    source order, as the local dense step does.  Returns per local vertex
    (best_w, best_label); vertices with no votes get (-inf, -1)."""
    C = _capacity(capacity, gidx.shape[0], axis_size(mesh))
    owner, local_idx = _routed_ids(gidx, att, mask_owner=True)
    (ridx, rlab, rw), recvv, _, _ = _route(
        (local_idx, labels.to(torch.int32), weights), owner, mesh, C)
    return segment_weighted_mode(torch.where(recvv, ridx, -1),
                                 torch.where(recvv, rlab, -1), rw,
                                 per_shard_n)


def buffered_flush(outbox: torch.Tensor, mesh, *,
                   combine: str) -> torch.Tensor:
    """Deliver a dense deferred-message buffer to its owner ranks: the
    async placement's exchange.  ``outbox`` is (S * per, ...) addressed by
    ``ATT.flat_slot`` with identity-filled empty slots (0 for 'add' / 'or',
    +inf for 'min', -inf for 'max'); one ``all_to_all`` transposes it and
    the S inbound slices are folded with ``combine``.  Returns the
    (per, ...) merged arrivals for this rank's residents."""
    S = axis_size(mesh)
    lead = outbox.shape[0]
    if lead % S != 0:
        raise ValueError(
            f"outbox leading dim {lead} is not divisible by {S} shards")
    arrived = _all_to_all(outbox, mesh).reshape(
        (S, lead // S) + tuple(outbox.shape[1:]))
    if combine == "add":
        return arrived.sum(dim=0)
    if combine == "min":
        return arrived.amin(dim=0)
    if combine == "max":
        return arrived.amax(dim=0)
    if combine == "or":
        out = arrived[0]
        for i in range(1, S):
            out = out | arrived[i]
        return out
    raise ValueError(f"unsupported combine {combine!r} for buffered_flush")


def all_gather_gather(local: torch.Tensor, gidx: torch.Tensor, att, mesh, *,
                      fill: float = 0.0) -> torch.Tensor:
    """Conventional-architecture baseline: replicate the whole array
    (``all_gather``), then index it locally."""
    g = mesh.all_gather(local)                      # (S, per, ...)
    if att.kind == "interleave":
        full = g.transpose(0, 1).reshape((-1,) + tuple(g.shape[2:]))
    else:
        full = g.reshape((-1,) + tuple(g.shape[2:]))
    return dma_gather(full[:att.n_global], gidx, fill=fill)


# ---------------------------------------------------------------------------
# Queue engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QueueState:
    """One rank's fixed-capacity work queue."""

    items: torch.Tensor   # (capacity,) int32, padding = -1
    count: torch.Tensor   # () int32, the valid prefix's length


def queue_make(capacity: int, device=None) -> QueueState:
    return QueueState(torch.full((capacity,), -1, dtype=torch.int32,
                                 device=device),
                      torch.zeros((), dtype=torch.int32, device=device))


def _leaves(tree):
    """(tensors, rebuild) of a payload: None, a tensor, or a tuple / list /
    dict of payloads."""
    if tree is None:
        return [], lambda xs: None
    if isinstance(tree, torch.Tensor):
        return [tree], lambda xs: xs[0]
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_leaves(tree[k]) for k in keys]
    elif isinstance(tree, (tuple, list)):
        keys = None
        parts = [_leaves(x) for x in tree]
    else:
        raise TypeError(f"payload leaves must be tensors, got "
                        f"{type(tree).__name__}")
    sizes = [len(p[0]) for p in parts]

    def rebuild(xs):
        out, i = [], 0
        for (_, rb), k in zip(parts, sizes):
            out.append(rb(xs[i:i + k]))
            i += k
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return [x for p in parts for x in p[0]], rebuild


def queue_balance(q: QueueState, mesh, payload=None):
    """Rebalance queued items evenly across ranks (hardware work
    stealing), as the reference does: every item gets a global rank from a
    prefix scan of the counts, the item of rank r moves to rank r % S
    through :func:`_route` (one ``all_to_all`` per plane), and what arrives
    is compacted, stably, into the same capacity — valid items first, by
    source rank and then in each sender's order.  Post-balance counts
    differ by at most 1, and the queue keeps its buffer size (the global
    count never exceeds S * capacity).

    payload: optional tensor, or tuple / list / dict of tensors, with
    leading dim == capacity, routed alongside the items (a walker's current
    vertex); rows without an item are zeroed.  Returns (QueueState,
    payload) when given, else the QueueState."""
    S = mesh.size
    cap = q.items.shape[0]
    dev = q.items.device
    offset = prefix_scan(q.count.reshape(()).to(torch.int32), mesh)
    pos = torch.arange(cap, dtype=torch.int32, device=dev)
    dest = torch.where(pos < q.count, (offset + pos) % S, -1)
    leaves, rebuild = _leaves(payload) if payload is not None else ([], None)
    recv, recvv, _, _ = _route((q.items,) + tuple(leaves),
                               dest.to(torch.int32), mesh, cap)
    order = torch.sort((~recvv).to(torch.int8), stable=True).indices[:cap]
    kept = recvv[order]
    out_q = QueueState(torch.where(kept, recv[0][order], -1),
                       recvv.sum().to(torch.int32))
    if payload is None:
        return out_q
    out = []
    for x in recv[1:]:
        xs = x[order]
        mask = kept.reshape((-1,) + (1,) * (xs.dim() - 1))
        out.append(torch.where(mask, xs, xs.new_zeros(())))
    return out_q, rebuild(out)


# ---------------------------------------------------------------------------
# Collective engine
# ---------------------------------------------------------------------------

def hierarchical_psum(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """Reduce one mesh level at a time (intra-block, then intra-pod, ...),
    as the reference's psum per axis name.  ``axes`` is a Mesh (one level)
    or a sequence of levels, each a Mesh or an axis name of ``mesh``
    (reduced over ``mesh.over(name)``'s group); over a rank grid the
    result is the sum over every rank of the named axes."""
    if hasattr(axes, "all_reduce"):
        return axes.all_reduce(x, "sum")
    for a in axes:
        level = a if hasattr(a, "all_reduce") else mesh.over(a)
        x = level.all_reduce(x, "sum")
    return x


def global_min(x: torch.Tensor, mesh) -> torch.Tensor:
    """Elementwise minimum over the ranks (the reference's ``lax.pmin``);
    under ``torch.func.vmap`` one collective serves every lane."""
    return mesh.all_reduce(x, "min")


def barrier(mesh) -> torch.Tensor:
    """System-wide barrier (a one-word reduction); returns the rank
    count."""
    return mesh.all_reduce(
        torch.ones((), dtype=torch.int32, device=mesh.device), "sum")


def prefix_scan(x: torch.Tensor, mesh) -> torch.Tensor:
    """Exclusive prefix sum across ranks (the collective engine's scan)."""
    g = mesh.all_gather(x)                          # (S, ...)
    return (torch.cumsum(g, 0) - g)[my_shard(mesh)]
