"""BBCSR SpMV / SpMSpV: torch wrappers of the CUDA kernels in
``csrc/bbcsr.cu``.

Counterpart of ``repro.kernels.spmv_dma``.  A wrapper given CPU tensors
computes the plain version from :mod:`.ref`; given CUDA tensors it launches
the kernel or raises (there is no fallback).  Each launch adds one to its
entry in :data:`LAUNCHES`, so a run can show that it went through the
kernels.

The contract kept from the TPU kernels: x is cast to f32 and padded to
``n_col_blocks * block_cols`` (0 for 'add', +inf / -inf for 'min' / 'max');
rows no live slot reaches come out as the combine identity; min/max read
only slots below ``tile_cnt``; inactive tiles do no work; the output is cut
to ``n_rows``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.graph import BBCSR
from . import _build
from . import ref

__all__ = ["spmv_bbcsr_kernel_call", "spmspv_bbcsr_kernel_call", "LAUNCHES",
           "reset_launches"]

# kernel launches per entry point since the last reset_launches()
LAUNCHES = {"spmv_bbcsr": 0, "spmspv_bbcsr_add": 0, "spmspv_bbcsr_select": 0}

_C_NAME = {"spmv_bbcsr": "bbcsr_spmv", "spmspv_bbcsr_add": "bbcsr_spmspv_add",
           "spmspv_bbcsr_select": "bbcsr_spmspv_select"}
_COMBINE_CODE = {"min": 1, "max": 2}
_SMEM_LIMIT = 48 * 1024      # static shared-memory budget of one CTA


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("bbcsr")
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        tiles = [P] * 5             # rows, cols, vals, tile_cb, tile_cnt
        geom = [I] * 5              # n_rows, n_rb, block_rows/cols, tile_nnz
        # then [tile_active,] rb_ptr, x, y, geometry, [combine,] stream
        lib.bbcsr_spmv.argtypes = tiles + [P, P, P] + geom + [P]
        lib.bbcsr_spmspv_add.argtypes = tiles + [P, P, P, P] + geom + [P]
        lib.bbcsr_spmspv_select.argtypes = tiles + [P, P, P, P] + geom + [I, P]
        for fn in (lib.bbcsr_spmv, lib.bbcsr_spmspv_add,
                   lib.bbcsr_spmspv_select):
            fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _operands(bb: BBCSR, tile_active=None) -> list:
    """The tile arrays in the C entry points' argument order."""
    act = [] if tile_active is None else [tile_active]
    return [bb.rows_local, bb.cols_local, bb.vals, bb.tile_cb, bb.tile_cnt,
            *act, bb.rb_ptr]


def _on_cpu(bb: BBCSR, x: torch.Tensor, tile_active=None) -> bool:
    """True when every operand lies on the CPU, False when all lie on one
    CUDA device; a mix raises."""
    ts = [t for t in _operands(bb, tile_active) if t is not None] + [x]
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"BBCSR operands and x span devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no BBCSR kernel for device {dev}")
    return dev.type == "cpu"


def _check(bb: BBCSR, x: torch.Tensor, tile_active=None) -> None:
    if bb.tile_cnt is None or bb.rb_ptr is None:
        raise ValueError("the BBCSR kernels need tile_cnt and rb_ptr: build "
                         "the operand with to_bbcsr or bbcsr_from_numpy")
    n_t, T = bb.n_tiles, bb.tile_nnz
    want = {"rows_local": (torch.int32, (n_t, T)),
            "cols_local": (torch.int32, (n_t, T)),
            "vals": (torch.float32, (n_t, T)),
            "tile_cb": (torch.int32, (n_t,)),
            "tile_cnt": (torch.int32, (n_t,)),
            "rb_ptr": (torch.int32, (bb.n_row_blocks + 1,))}
    for name, (dtype, shape) in want.items():
        t = getattr(bb, name)
        if t.dtype != dtype or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(f"bb.{name}: want contiguous {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if tile_active is not None and (
            tile_active.dtype != torch.int32
            or tuple(tile_active.shape) != (n_t,)
            or not tile_active.is_contiguous()):
        raise ValueError(f"tile_active: want contiguous int32 ({n_t},), got "
                         f"{tile_active.dtype} {tuple(tile_active.shape)}")
    if x.dim() != 1 or x.shape[0] > bb.n_col_blocks * bb.block_cols:
        raise ValueError(f"x: want a vector of at most "
                         f"{bb.n_col_blocks * bb.block_cols} entries, got "
                         f"{tuple(x.shape)}")
    if 4 * bb.block_rows > _SMEM_LIMIT:
        raise ValueError(f"block_rows={bb.block_rows} needs more than "
                         f"{_SMEM_LIMIT} B of shared memory per CTA")


def _launch(entry: str, bb: BBCSR, x: torch.Tensor, combine: str,
            tile_active=None) -> torch.Tensor:
    _check(bb, x, tile_active)
    x_pad = ref.pad_x(bb, x, ref.combine_identity(combine))
    y = torch.empty(bb.n_rows, dtype=torch.float32, device=x.device)
    lib = _lib()
    ptrs = [t.data_ptr() for t in _operands(bb, tile_active)]
    ptrs += [x_pad.data_ptr(), y.data_ptr()]
    geom = [bb.n_rows, bb.n_row_blocks, bb.block_rows, bb.block_cols,
            bb.tile_nnz]
    extra = [_COMBINE_CODE[combine]] if entry == "spmspv_bbcsr_select" else []
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _C_NAME[entry])(*ptrs, *geom, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    LAUNCHES[entry] += 1
    return y


def spmv_bbcsr_kernel_call(bb: BBCSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over every tile.  Returns (n_rows,) float32."""
    if _on_cpu(bb, x):
        return ref.spmv_bbcsr_ref(bb, x)
    return _launch("spmv_bbcsr", bb, x, "add")


def spmspv_bbcsr_kernel_call(bb: BBCSR, x: torch.Tensor,
                             tile_active: torch.Tensor, *,
                             combine: str = "add") -> torch.Tensor:
    """y = A ⊕ x for a sparsely populated x, ⊕ per ``combine``.

    ``tile_active`` is (n_tiles,) int32, nonzero iff the tile's column block
    holds an active x entry (``engine.tile_active``); other tiles do no
    work.  'add' sums val * x[col]; 'min' / 'max' relax x[col] + val (the
    distance semirings) over the slots below ``tile_cnt``.  Untouched rows
    return the combine identity.
    """
    ref.combine_identity(combine)          # validates the combine name
    if _on_cpu(bb, x, tile_active):
        return ref.spmspv_bbcsr_ref(bb, x, tile_active, combine=combine)
    entry = "spmspv_bbcsr_add" if combine == "add" else "spmspv_bbcsr_select"
    return _launch(entry, bb, x, combine, tile_active)
