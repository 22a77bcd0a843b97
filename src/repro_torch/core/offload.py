"""Offload engines, local part: DMA gather and scatter-add (counterpart of
the in-node ops of ``repro.core.offload``).  The remote, queue and
collective engines belong to the distributed placement."""
from __future__ import annotations

import torch

__all__ = ["dma_gather", "dma_scatter_add"]


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
