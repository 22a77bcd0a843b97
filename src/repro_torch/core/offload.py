"""Offload engines, local part: DMA gather, scatter-add and the lane-word
OR combine (counterpart of the in-node ops of ``repro.core.offload``).  The
remote, queue and collective engines belong to the distributed
placement."""
from __future__ import annotations

import torch

__all__ = ["dma_gather", "dma_scatter_add", "segment_or"]


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
