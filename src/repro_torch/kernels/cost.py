"""The work of each hand-written kernel: the bytes it must move (each input
read once, each output written once) and the operations it does, from its
shapes (and, for the BBCSR kernels, the tiles' real slots).

One source for every reader: ``launch.dryrun`` counts B4 and B6 with these
formulas (their ``torch.utils.flop_counter`` formulas and the dry run's
byte count), and ``chip_smoke.py``'s bounds put them through
:func:`bound_s` over the card's rates (``launch.mesh.HW``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["bbcsr_bytes", "segment_sum_bytes", "segment_sum_strict_bytes",
           "segment_sum_flops", "visible_pairs", "attention_flops",
           "attention_bytes", "bound_s"]


def bbcsr_bytes(bb, tile_active=None) -> int:
    """B1 (SpMV; ``tile_active`` None) and B2 / B3 (SpMSpV): 12 B per real
    slot of the tiles the kernel processes (value, column, row), their
    tile_cb and tile_cnt, the tile_active flags, rb_ptr, x (padded) and y.
    Reads the tile counts (a device read)."""
    import torch
    live = bb.tile_cnt if tile_active is None else \
        torch.where(tile_active != 0, bb.tile_cnt, 0)
    n_live = bb.n_tiles if tile_active is None else \
        int((tile_active != 0).sum())
    return (12 * int(live.long().sum()) + 8 * n_live
            + (0 if tile_active is None else 4 * bb.n_tiles)
            + 4 * (bb.n_row_blocks + 1)
            + 4 * bb.n_col_blocks * bb.block_cols + 4 * bb.n_rows)


def segment_sum_bytes(entries: int, d: int, segments: int) -> int:
    """B4 over ``entries`` f32 rows of width d into ``segments`` rows: the
    rows (gathered or not) and their ids read once, the output written
    once."""
    return 4 * entries * d + 4 * entries + 4 * segments * d


def segment_sum_strict_bytes(table_rows: int, entries: int, d: int,
                             segments: int) -> int:
    """B4 with the row gather fused in, strict: the table read once (only
    an L2 that held it whole would come near), the ids and the (segments
    + 1) int64 offsets read once, the output written once."""
    return (4 * table_rows * d + 4 * entries + 8 * (segments + 1)
            + 4 * segments * d)


def segment_sum_flops(entries: int, d: int) -> int:
    """B4's f32 adds: one per entry and column."""
    return entries * d


def visible_pairs(sq: int, skv: int, causal: bool,
                  window: Optional[int]) -> int:
    """The (query, key) pairs attention's mask keeps: the queries at the
    last Sq of the Skv positions (p = i + Skv - Sq), causal keeping keys
    j <= p, a window keys j > p - window (``ref.attention_mask``)."""
    p = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = np.minimum(p, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.zeros(sq, np.int64) if window is None else \
        np.maximum(p - int(window) + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_flops(batch: int, hq: int, sq: int, skv: int, d: int,
                    causal: bool, window: Optional[int]) -> int:
    """B6's multiply-adds on the visible pairs only, 4 D each: q.k and the
    weighting of v, per batch entry and query head."""
    return 4 * d * batch * hq * visible_pairs(sq, skv, causal, window)


def attention_bytes(q_numel: int, kv_numel: int, elem: int) -> int:
    """B6: q and k, v read once, the output (q's shape) written once."""
    return elem * (2 * q_numel + 2 * kv_numel)


def bound_s(nbytes: float, flops: float, hw: dict) -> tuple:
    """(the least seconds for this work on the card of ``hw``, what binds
    it: 'bytes' or 'operations'): the larger of the bytes over the memory
    rate and the operations over the bf16 peak."""
    by_bytes, by_ops = nbytes / hw["hbm_bw"], flops / hw["peak_bf16_flops"]
    return (by_ops, "operations") if by_ops >= by_bytes else \
        (by_bytes, "bytes")
