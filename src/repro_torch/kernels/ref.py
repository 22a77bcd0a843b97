"""Plain torch versions of the BBCSR kernels, computed straight off the tile
arrays.  The wrappers in :mod:`.spmv_dma` take them for CPU tensors, and
the card's checks hold each kernel against them.

The 'add' versions form each product in float32, as the kernels do, and
accumulate in float64 before rounding once to float32: the kernels' sums
run in no fixed order, so the plain side is kept close to the exact sum and
a comparison measures the kernel's own rounding."""
from __future__ import annotations

import torch

from ..core.graph import BBCSR

__all__ = ["spmv_bbcsr_ref", "spmspv_bbcsr_ref", "combine_identity"]


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
