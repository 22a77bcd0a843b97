"""Plain torch versions of the port's kernels: the BBCSR products computed
straight off the tile arrays, segment sum, segment OR, the weighted label
mode and in-order run sums, EmbeddingBag and attention.  The kernel wrappers take them for CPU tensors, and the card's
checks hold each kernel against them.

The 'add' versions form each product in float32, as the kernels do, and
accumulate in float64 before rounding once to float32: the kernels' sums
run in no fixed order, so the plain side is kept close to the exact sum and
a comparison measures the kernel's own rounding."""
from __future__ import annotations

from typing import Optional

import torch

from ..core.graph import BBCSR

__all__ = ["spmv_bbcsr_ref", "spmspv_bbcsr_ref", "combine_identity",
           "segment_sum_ref", "segment_or_ref", "run_sum_ref",
           "segment_mode_ref", "embedding_bag_ref",
           "embedding_bag_pieces_ref",
           "attention_mask",
           "flash_attention_ref", "attention_pieces", "combine_pieces",
           "flash_attention_split_ref"]

_LOG2E = 1.4426950408889634


def combine_identity(combine: str) -> float:
    if combine == "add":
        return 0.0
    if combine == "min":
        return float("inf")
    if combine == "max":
        return float("-inf")
    raise ValueError(f"combine must be 'add', 'min' or 'max', got {combine!r}")


def pad_x(bb: BBCSR, x: torch.Tensor, fill: float) -> torch.Tensor:
    """x as f32, padded to n_col_blocks*block_cols with ``fill``."""
    out = torch.full((bb.n_col_blocks * bb.block_cols,), fill,
                     dtype=torch.float32, device=x.device)
    out[:x.shape[0]] = x.to(torch.float32)
    return out


def _global_ids(bb: BBCSR):
    rows = (bb.tile_rb[:, None] * bb.block_rows + bb.rows_local).reshape(-1)
    cols = (bb.tile_cb[:, None] * bb.block_cols + bb.cols_local).reshape(-1)
    return rows, cols


def spmv_bbcsr_ref(bb: BBCSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over every slot of every tile (padding vals are 0)."""
    rows, cols = _global_ids(bb)
    contrib = bb.vals.reshape(-1) * torch.index_select(pad_x(bb, x, 0.0), 0,
                                                       cols)
    y = torch.zeros(bb.n_row_blocks * bb.block_rows, dtype=torch.float64,
                    device=x.device)
    return y.index_add_(0, rows, contrib.double())[:bb.n_rows].float()


def spmspv_bbcsr_ref(bb: BBCSR, x: torch.Tensor, tile_active: torch.Tensor,
                     *, combine: str = "add") -> torch.Tensor:
    """y = A ⊕ x over the real slots (``slot < tile_cnt``) of the active
    tiles only.  'add' sums val * x[col]; 'min' / 'max' reduce
    x[col] + val.  Rows no active slot reaches get the combine identity."""
    ident = combine_identity(combine)
    if bb.tile_cnt is None:
        raise ValueError("the SpMSpV combines need the BBCSR per-tile counts "
                         "(tile_cnt): rebuild the operand with to_bbcsr")
    rows, cols = _global_ids(bb)
    slot = torch.arange(bb.tile_nnz, device=x.device)
    live = (slot[None, :] < bb.tile_cnt[:, None]) & \
        (tile_active != 0)[:, None]
    xg = torch.index_select(pad_x(bb, x, ident), 0, cols)
    vals = bb.vals.reshape(-1)
    y = torch.full((bb.n_row_blocks * bb.block_rows,), ident,
                   dtype=torch.float32, device=x.device)
    if combine == "add":
        contrib = torch.where(live.reshape(-1), vals * xg, 0.0)
        return y.double().index_add_(0, rows, contrib.double())[
            :bb.n_rows].float()
    contrib = torch.where(live.reshape(-1), xg + vals, ident)
    y.scatter_reduce_(0, rows.long(), contrib,
                      "amin" if combine == "min" else "amax",
                      include_self=True)
    return y[:bb.n_rows]


def segment_sum_ref(data: torch.Tensor, seg: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """out[s] = sum of data rows with seg == s, in any order of seg; rows
    with seg outside [0, num_segments) are dropped.  (N, d) -> (M, d)
    float32, accumulated in float64."""
    keep = (seg >= 0) & (seg < num_segments)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=torch.float64, device=data.device)
    out.index_add_(0, seg[keep].long(), data[keep].double())
    return out.float()


def segment_or_ref(idx: torch.Tensor, words: torch.Tensor,
                   n: int) -> torch.Tensor:
    """out (n, W) int32: out[v] = bitwise OR of the rows of words (m, W)
    int32 with idx == v; ids outside [0, n) are dropped, a destination with
    no items gets 0.  One exact max-scatter per bit (torch has no OR
    scatter)."""
    W = words.shape[1]
    keep = (idx >= 0) & (idx < n)
    index = idx[keep].long()[:, None].expand(-1, W)
    words = words[keep].to(torch.int32)
    out = torch.zeros((n, W), dtype=torch.int32, device=words.device)
    for s in range(32):
        hit = torch.zeros_like(out).scatter_reduce_(0, index, (words >> s) & 1,
                                                    "amax")
        # bit 31 is the sign bit: -2^31, not 1 << 31, stays in int32
        out |= hit * (1 << s if s < 31 else -(1 << 31))
    return out


def run_sum_ref(idx: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """out (n,): out[v] = the weights of the items with idx == v added one
    after the other in stream order, from 0 (the reference's
    ``jax.ops.segment_sum`` on the CPU), in f32 — f64 for float64 weights;
    ids outside [0, n) dropped.

    torch's CPU ``index_add_`` adds in item order (held by the port's
    tests); on the card its atomics do not, so CUDA inputs are summed on
    the host and the result moved back."""
    dtype = torch.float64 if w.dtype == torch.float64 else torch.float32
    keep = (idx >= 0) & (idx < n)
    idx, w = idx[keep].long().cpu(), w[keep].to(dtype).cpu()
    return torch.zeros(n, dtype=dtype).index_add_(0, idx, w).to(keep.device)


def segment_mode_ref(dst: torch.Tensor, label: torch.Tensor, w: torch.Tensor,
                     n: int):
    """(best_w (n,) f32, best_label (n,) int32) over a stream sorted by
    (dst, label), labels >= 0: each (dst, label) run's weights summed in
    stream order (:func:`run_sum_ref`), then the reference's two-plane pick
    (``offload.segment_argmax``: the largest sum, the smallest label that
    reaches it); (-inf, -1) where no run sums above -inf."""
    from ..core.offload import run_starts, segment_argmax
    if dst.numel() == 0:
        return (torch.full((n,), float("-inf"), device=w.device),
                torch.full((n,), -1, dtype=torch.int32, device=w.device))
    start, run = run_starts(dst, label)
    sums = run_sum_ref(run, w, int(run[-1]) + 1)
    return segment_argmax(torch.where(start, dst.long(), -1), sums[run],
                          label, n)


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor,
                      bag: torch.Tensor, n_bags: int,
                      weights: Optional[torch.Tensor] = None,
                      mode: str = "sum") -> torch.Tensor:
    """Sum (or weighted mean) of table rows grouped by bag id, in any order
    of the stream.  idx < 0 (padding) adds 0 and counts nothing; 'mean'
    divides by the sum of the weights of the valid lookups (their number
    when unweighted), floored at 1e-9.  Accumulated in float64."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    valid = (idx >= 0) & (idx < table.shape[0])
    w = valid.double() if weights is None else \
        torch.where(valid, weights.double(), 0.0)
    rows = table[torch.where(valid, idx, 0).long()].double() * w[:, None]
    # bag ids outside [0, n_bags) give nothing, as in the kernel
    keep = (bag >= 0) & (bag < n_bags)
    out = torch.zeros((n_bags, table.shape[1]), dtype=torch.float64,
                      device=table.device)
    out.index_add_(0, bag[keep].long(), rows[keep])
    if mode == "mean":
        cnt = torch.zeros(n_bags, dtype=torch.float64, device=table.device)
        cnt.index_add_(0, bag[keep].long(), w[keep])
        out = out / cnt.clamp_min(1e-9)[:, None]
    return out.float()


def _fold(x: torch.Tensor, starts: torch.Tensor, n: int) -> torch.Tensor:
    """For each run [starts[p], starts[p + 1]) of x (the last to n), its
    rows added one after the other in float32, starting from 0."""
    ends = torch.cat([starts[1:], starts.new_tensor([n])])
    length = ends - starts
    acc = x.new_zeros((starts.shape[0],) + tuple(x.shape[1:]))
    for k in range(int(length.max()) if starts.numel() else 0):
        live = length > k
        acc[live] = acc[live] + x[starts[live] + k]
    return acc


def embedding_bag_pieces_ref(table: torch.Tensor, idx: torch.Tensor,
                             bag: torch.Tensor, n_bags: int,
                             starts: torch.Tensor,
                             weights: Optional[torch.Tensor] = None,
                             mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag summed as the CUDA kernel sums it, in float32: the
    stream (sorted by bag) is cut into pieces at ``starts`` (each a run of
    one bag; ``embedding_bag.bag_pieces``); each piece's rows, times their
    weights (0 for idx < 0 or >= V), are added in stream order from 0, and
    so are its weights; a bag's pieces are added in stream order, starting
    from the first.  'mean' divides by the bag's summed weights, floored at
    1e-9.  Bags with no lookup, and bag ids outside [0, n_bags), give
    nothing: their rows are 0."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    n, d = idx.shape[0], table.shape[1]
    valid = (idx >= 0) & (idx < table.shape[0])
    w = valid.float() if weights is None else \
        torch.where(valid, weights.float(), 0.0)
    rows = torch.where(valid[:, None],
                       table[torch.where(valid, idx, 0).long()].float() *
                       w[:, None], 0.0)
    piece_sum, piece_w = _fold(rows, starts, n), _fold(w, starts, n)
    # a bag's pieces are consecutive: fold them the same way
    piece_bag = bag[starts].long()
    first = torch.ones_like(piece_bag, dtype=torch.bool)
    first[1:] = piece_bag[1:] != piece_bag[:-1]
    group = torch.nonzero(first).squeeze(1)
    total = _fold(piece_sum, group, starts.shape[0])
    total_w = _fold(piece_w, group, starts.shape[0])
    if mode == "mean":
        total = total / total_w.clamp_min(1e-9)[:, None]
    out = torch.zeros((n_bags, d), dtype=torch.float32, device=table.device)
    ids = piece_bag[group]
    keep = (ids >= 0) & (ids < n_bags)
    out[ids[keep]] = total[keep]
    return out


def attention_mask(sq: int, skv: int, causal: bool, window: Optional[int],
                   device) -> torch.Tensor:
    """(Sq, Skv) bool, True where key j is visible to query row i: the
    queries sit at the last Sq of the Skv positions, p = i + Skv - Sq;
    causal keeps j <= p, a window keeps j > p - window."""
    qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Attention in float32 with GQA (kv head = h // g), the causal and
    window masks of :func:`attention_mask`, and 0 for rows that see no key.

    q (B, Hq, Sq, D); k (B, Hkv, Skv, D); v (B, Hkv, Skv, Dv), Dv D or
    another (MLA's).  The g query heads of a kv head are folded into q's
    rows, as (Hkv, g * Sq, D), so k and v are never repeated; one batch
    entry at a time, so the logits of a long cache stay small.  Returns
    (B, Hq, Sq, Dv) in q.dtype; differentiable."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    mask = attention_mask(Sq, Skv, causal, window, q.device).repeat(g, 1)
    out = q.new_empty((B, Hq, Sq, Dv))
    for b in range(B):
        qf = q[b].reshape(Hkv, g * Sq, D).float()
        logits = torch.matmul(qf, k[b].float().transpose(1, 2)) * scale
        logits.masked_fill_(~mask, float("-inf"))
        # out of place: softmax's backward reads its own output
        p = torch.softmax(logits, dim=-1).nan_to_num(nan=0.0)
        out[b] = torch.matmul(p, v[b].float()).reshape(Hq, Sq, Dv).to(q.dtype)
    return out


def attention_pieces(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_ranges, *, causal: bool = True,
                     window: Optional[int] = None,
                     scale: Optional[float] = None):
    """The per-split pieces of the split decode path: for each key range
    [a, b) of ``key_ranges``, each query row's (m, l, acc) over the visible
    keys of that range alone, in float32 as the kernels keep them: m the
    largest logit times scale * log2(e) (-inf where the row sees no key of
    the range), l the sum of exp2(logit - m), acc that weighting of v,
    unnormalised.  Returns m, l (P, B, Hq, Sq) and acc (P, B, Hq, Sq, D)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    mask = attention_mask(Sq, Skv, causal, window, q.device).repeat(g, 1)
    qf = q.reshape(B, Hkv, g * Sq, D).float()
    ms, ls, accs = [], [], []
    for a, b in key_ranges:
        x = torch.matmul(qf, k[:, :, a:b].float().transpose(2, 3)) * \
            (scale * _LOG2E)
        x.masked_fill_(~mask[:, a:b], float("-inf"))
        m = x.amax(dim=-1)
        mu = torch.where(m == float("-inf"), 0.0, m)
        p = torch.exp2(x - mu[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.matmul(p, v[:, :, a:b].float()))
    shape = (len(ms), B, Hq, Sq)
    return (torch.stack(ms).reshape(shape), torch.stack(ls).reshape(shape),
            torch.stack(accs).reshape(shape + (D,)))


def combine_pieces(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """Merge the pieces of :func:`attention_pieces` in split order, as the
    combine kernel does: each piece weighted by exp2(m_s - max m) (0 for a
    piece that saw no key), summed piece after piece, divided by the summed
    weighted l (0 where it is 0)."""
    mx = m.amax(dim=0)
    mu = torch.where(mx == float("-inf"), 0.0, mx)
    lsum = torch.zeros_like(l[0])
    out = torch.zeros_like(acc[0])
    for s in range(m.shape[0]):
        w = torch.exp2(m[s] - mu)
        lsum = lsum + w * l[s]
        out = out + w[..., None] * acc[s]
    inv = torch.where(lsum > 0, 1.0 / lsum.clamp_min(1e-30), 0.0)
    return (out * inv[..., None]).to(dtype)


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, key_ranges, *,
                              causal: bool = True,
                              window: Optional[int] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Attention computed as the split decode path computes it: pieces over
    the contiguous ``key_ranges`` (which together must cover every visible
    key), merged in split order.  Returns q's shape in q.dtype."""
    m, l, acc = attention_pieces(q, k, v, key_ranges, causal=causal,
                                 window=window, scale=scale)
    return combine_pieces(m, l, acc, q.dtype)
