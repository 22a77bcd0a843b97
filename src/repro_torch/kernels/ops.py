"""Public wrappers for the port's kernels (counterpart of
``repro.kernels.ops``).  CPU tensors take the plain torch version, CUDA
tensors the hand-written kernel; see :mod:`.spmv_dma`."""
from __future__ import annotations

import torch

from ..core.graph import BBCSR
from . import spmv_dma as _spmv

__all__ = ["spmv_dma", "spmspv_dma"]


def spmv_dma(bb: BBCSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over the BBCSR tiles."""
    return _spmv.spmv_bbcsr_kernel_call(bb, x)


def spmspv_dma(bb: BBCSR, x: torch.Tensor, tile_active: torch.Tensor, *,
               combine: str = "add") -> torch.Tensor:
    """y = A ⊕ x for sparse x; tiles whose column block is inactive (per
    `tile_active`, see `core.engine.tile_active`) do no work.  combine:
    'add' (val * x[col]) or 'min' / 'max' (x[col] + val, the distance
    semirings; needs bb.tile_cnt)."""
    return _spmv.spmspv_bbcsr_kernel_call(bb, x, tile_active, combine=combine)
