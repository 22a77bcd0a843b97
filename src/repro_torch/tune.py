"""Tunable defaults of the port's graph path.

A copy of the entries of ``repro.tune.space.DEFAULTS`` that this package
reads: the BBCSR tile geometry per kernel family, the SSSP bucket-width
multiplier, the engine's push-routing capacity knobs, the service's lane
budget and the tiles of the segment-sum and flash-attention kernels.
:func:`resolve` is the reference resolver's answer on a backend
with no tuned entry: the explicit value when given, else the default.  The
port keeps no tuned-parameter file yet.
"""
from __future__ import annotations

from typing import Any

__all__ = ["DEFAULTS", "resolve"]

DEFAULTS = {
    # BBCSR tile geometry per kernel family: 'add' is val*msg (spmv_dma,
    # spmspv_dma combine='add'); 'min' is the (min,+)/(max,+) relaxation.
    "kernels.bbcsr_add.block_rows": 256,
    "kernels.bbcsr_add.block_cols": 512,
    "kernels.bbcsr_add.tile_nnz": 512,
    "kernels.bbcsr_min.block_rows": 256,
    "kernels.bbcsr_min.block_cols": 512,
    "kernels.bbcsr_min.tile_nnz": 512,
    # multiplier on the auto_delta histogram quantile (algorithms/sssp).
    "sssp.delta_scale": 1.0,
    # push while |frontier| <= switch_frac * n; the compacted push's routing
    # capacity is m * switch_frac * push_slack
    # (engine.frontier_edge_capacity, which the service's route-byte model
    # prices).
    "engine.switch_frac": 1 / 32,
    "engine.push_slack": 4.0,
    # lanes per GraphService micro-batch.
    "service.batch_budget": 32,
    # The port kernels' own tiles, not the reference's TPU values (512 and
    # 128 there, sized to VMEM and the 128-wide MXU).  segment_sum: rows of
    # data one CTA walks (csrc/segment_sum.cu; its 8 warps split them).
    "kernels.segment_sum.block_n": 2048,
    # flash_attention, the folded (decode and f32) paths: block_q is the
    # rows of the folded (query position x group head) space one CTA
    # serves, 16 per warp (16, 32, 64 or 128); block_k the keys per
    # shared-memory tile (32 or 64; csrc/flash_attention.cu).  The bf16
    # wgmma path has its fixed 128 x 128 tile.
    "kernels.flash_attention.block_q": 64,
    "kernels.flash_attention.block_k": 64,
}


def resolve(name: str, explicit: Any = None) -> Any:
    """Resolve tunable ``name``: ``explicit`` when not None, else the
    default."""
    if explicit is not None:
        return explicit
    if name not in DEFAULTS:
        raise KeyError(f"unknown tunable {name!r}")
    return DEFAULTS[name]
