"""Public wrappers for the port's kernels (counterpart of
``repro.kernels.ops``).  CPU tensors take the plain torch version, CUDA
tensors the hand-written kernel; see :mod:`.spmv_dma`, :mod:`.segment_sum`,
:mod:`.embedding_bag` and :mod:`.flash_attention`.  B4 and B6 also take
meta tensors (a dry run, ``launch.dryrun``): their torch operators' meta
kernels give the output's shape.  Tile sizes left as None resolve through
:mod:`repro_torch.tune` (meta tensors as the card's)."""
from __future__ import annotations

from typing import Optional

import torch

from .. import tune as _tune
from ..core.graph import BBCSR
from . import embedding_bag as _eb
from . import flash_attention as _fa
from . import segment_sum as _ss
from . import spmv_dma as _spmv

__all__ = ["spmv_dma", "spmspv_dma", "segment_sum_sorted", "segment_sum_csr",
           "embedding_bag", "flash_attention"]


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


def segment_sum_sorted(data: torch.Tensor, seg: torch.Tensor,
                       num_segments: int, *,
                       block_n: Optional[int] = None) -> torch.Tensor:
    """Segment sum of data (N, d) by seg (N,) into (num_segments, d)
    float32; seg = -1 rows are dropped.  Sorted ids are the contract of the
    reference; the port takes any order and any size: on CUDA tensors a plan
    of seg (:class:`.segment_sum.SegmentPlan`), then B4 on data's rows in
    plan order.

    block_n: see :func:`segment_sum_csr`."""
    block_n = int(_tune.resolve("kernels.segment_sum.block_n", block_n,
                                n=num_segments, device=data.device))
    return _ss.segment_sum_kernel_call(data, seg, num_segments,
                                       block_n=block_n)


def segment_sum_csr(table: torch.Tensor, offsets: torch.Tensor,
                    rows: Optional[torch.Tensor] = None, *,
                    block_n: Optional[int] = None) -> torch.Tensor:
    """B4 as a CSR row reduction with an optional row gather: out (M, d)
    float32, out[s] = the sum of table's rows rows[j] (None: row j) for j
    in [offsets[s], offsets[s + 1]), in the order of j; a rows[j] outside
    [0, len(table)) adds 0.  A :class:`.segment_sum.SegmentPlan` gives
    offsets and the order of a segment-id stream.

    block_n: the rows plus entries one group of lanes walks before a row is
    cut into pieces (:func:`.segment_sum.segment_sum_csr_call`); None takes
    the tuned value (:mod:`repro_torch.tune`; an explicit value wins)."""
    block_n = int(_tune.resolve("kernels.segment_sum.block_n", block_n,
                                n=offsets.numel() - 1, device=table.device))
    return _ss.segment_sum_csr_call(table, offsets, rows, block_n=block_n)


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, bag: torch.Tensor,
                  n_bags: int, weights: Optional[torch.Tensor] = None,
                  mode: str = "sum", *,
                  presorted: bool = False) -> torch.Tensor:
    """EmbeddingBag(sum|mean).  idx (N,) int (-1 pad), bag (N,) int in
    [0, n_bags).  'mean' divides by the sum of the weights of the valid
    lookups (their number when unweighted).

    The kernel needs the stream sorted by bag; unless `presorted`, this
    wrapper adds one sentinel (idx -1) per bag and sorts (stable).  A bag
    with no lookups comes out as 0."""
    if not presorted:
        dev = idx.device
        idx = torch.cat([idx.to(torch.int32),
                         torch.full((n_bags,), -1, dtype=torch.int32,
                                    device=dev)])
        bag = torch.cat([bag.to(torch.int32),
                         torch.arange(n_bags, dtype=torch.int32, device=dev)])
        if weights is not None:
            weights = torch.cat([weights, weights.new_zeros(n_bags)])
        order = torch.sort(bag, stable=True).indices
        idx, bag = idx[order], bag[order]
        weights = None if weights is None else weights[order]
    return _eb.embedding_bag_kernel_call(table, idx, bag, n_bags, weights,
                                         mode=mode)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Flash attention with GQA / causal / sliding window; see
    :mod:`.flash_attention`.  Raises ValueError where a query row would see
    no key (causal with Sq > Skv, or window < 1).

    block_q / block_k: the folded kernels' tile (folded rows per CTA, keys
    per tile; the bf16 wgmma path, which prefill and window calls take, has
    a fixed 128 x 128 tile); None takes the tuned values
    (:mod:`repro_torch.tune`; explicit values win)."""
    seq = q.shape[-2]
    block_q = int(_tune.resolve("kernels.flash_attention.block_q", block_q,
                                n=seq, device=q.device))
    block_k = int(_tune.resolve("kernels.flash_attention.block_k", block_k,
                                n=seq, device=q.device))
    return _fa.flash_attention_kernel_call(
        q, k, v, causal=causal, window=window, scale=scale, block_q=block_q,
        block_k=block_k)
