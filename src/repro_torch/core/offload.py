"""Offload engines, local part: DMA gather, scatter-add, the lane-word OR
combine and the structured segment combines (counterpart of the in-node
ops of ``repro.core.offload``).  The remote, queue and collective engines
belong to the distributed placement.

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

import torch

__all__ = ["LABEL_PAD", "dma_gather", "dma_scatter_add", "segment_or",
           "segment_argmax", "run_starts", "segment_weighted_mode",
           "compact_labels", "run_sum", "segment_sum_ordered", "tree_sum"]

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
