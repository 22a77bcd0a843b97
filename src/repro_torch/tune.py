"""Tunable defaults of the port's graph path.

A copy of the entries of ``repro.tune.space.DEFAULTS`` that this package
reads: the BBCSR tile geometry per kernel family and the SSSP bucket-width
multiplier.  :func:`resolve` is the reference resolver's answer on a backend
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
}


def resolve(name: str, explicit: Any = None) -> Any:
    """Resolve tunable ``name``: ``explicit`` when not None, else the
    default."""
    if explicit is not None:
        return explicit
    if name not in DEFAULTS:
        raise KeyError(f"unknown tunable {name!r}")
    return DEFAULTS[name]
