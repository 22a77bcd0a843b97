"""BBCSR SpMV / SpMSpV: torch wrappers of the CUDA kernels in
``csrc/bbcsr.cu``.

Counterpart of ``repro.kernels.spmv_dma``.  A wrapper given CPU tensors
computes the plain version from :mod:`.ref`; given CUDA tensors it launches
the kernel or raises (there is no fallback).  Each launch adds one to its
entry in :data:`LAUNCHES`, so a run can show that it went through the
kernels.

The contract kept from the TPU kernels: x is cast to f32 and read as if
padded to ``n_col_blocks * block_cols`` (0 for 'add', +inf / -inf for 'min'
/ 'max': the kernels read the identity past x's end);
rows no live slot reaches come out as the combine identity; only slots below
``tile_cnt`` are read; inactive tiles do no work; the output is cut to
``n_rows``.

The kernels split the live slots into equal shares, one warp each (see
the note at the top of ``csrc/bbcsr.cu``): ``live / SHARES`` slots rounded
up to 32 and held within [SHARE_MIN, SHARE_MAX].  Their schedule, the
:class:`Plan`, is built on the device: once per operand for SpMV (kept
here, keyed by the operand), at each call for SpMSpV.  :func:`plan` builds
it alone, and on CPU tensors gives its plain version.
"""
from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple, Optional

import torch

from ..core.graph import BBCSR
from . import _build
from . import ref

__all__ = ["spmv_bbcsr_kernel_call", "spmspv_bbcsr_kernel_call", "LAUNCHES",
           "reset_launches", "SHARES", "SHARE_MIN", "SHARE_MAX", "Plan",
           "plan", "plan_ref", "share_size"]

# kernel launches per entry point since the last reset_launches()
LAUNCHES = {"spmv_bbcsr": 0, "spmspv_bbcsr_add": 0, "spmspv_bbcsr_select": 0}

# the shares of live slots: about SHARES of them (some 4,096 warps fill an
# H100), each a multiple of 32 slots within [SHARE_MIN, SHARE_MAX]
SHARES = 4096
SHARE_MIN = 128
SHARE_MAX = 4096
_COMBINE_CODE = {"add": 0, "min": 1, "max": 2}
_PLAN_TILES = 2048           # tiles per CTA of the plan kernels
_SMEM_LIMIT = 227 * 1024     # shared memory one CTA may opt in to (H100)

# operand id -> its SpMV Plan (None until the first SpMV), kept once the
# operand has passed its checks and dropped with the operand
_OPERANDS: dict = {}


class Plan(NamedTuple):
    """The schedule of one product over the live tiles (tile_cnt > 0 and,
    for SpMSpV, tile_active != 0), all int32:

    list_tile   : the live tiles in order (first ``meta[0]`` entries)
    list_ptr    : live slots before each listed tile, then the total
    chunk_first : the list entry holding live slot k * share, for
                  k < meta[1], then ``meta[0]``
    rb_slot     : (n_row_blocks + 1,) live slots before each row block,
                  then the total
    meta        : (n_list, n_chunks, share)

    On the card the arrays are the kernel's buffers, valid up to the
    lengths ``meta`` gives; the plain version's are cut to them."""
    list_tile: torch.Tensor
    list_ptr: torch.Tensor
    chunk_first: torch.Tensor
    rb_slot: torch.Tensor
    meta: torch.Tensor


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("bbcsr")
    if not getattr(lib, "_argtypes_set", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        # tile_cnt, tile_active, tile_rb, n_tiles, n_rb, shares, share_min,
        # share_max, gsum, list_tile, list_ptr, chunk_first, rb_slot, meta
        lib.bbcsr_plan.argtypes = [P] * 3 + [I] * 5 + [P] * 6 + [P]
        # rows, cols, vals, tile_cb, tile_rb, the plan (5), x, n_x, y,
        # scratch, n_rows, n_rb, block_rows/cols, tile_nnz, max_chunks
        lib.bbcsr_spmv.argtypes = [P] * 11 + [I] + [P] * 2 + [I] * 6 + [P]
        # rows, cols, vals, tile_cb, tile_cnt, tile_rb, tile_active, x, n_x,
        # y, work, scratch, n_rows, n_tiles, n_rb, block_rows/cols,
        # tile_nnz, shares, share_min, share_max, max_chunks, combine
        lib.bbcsr_spmspv.argtypes = [P] * 8 + [I] + [P] * 3 + [I] * 11 + [P]
        for fn in (lib.bbcsr_plan, lib.bbcsr_spmv, lib.bbcsr_spmspv):
            fn.restype = ctypes.c_int
        lib.bbcsr_smem_bytes.argtypes = [I]
        lib.bbcsr_smem_bytes.restype = ctypes.c_longlong
        lib._argtypes_set = True
    return lib


def _operands(bb: BBCSR, tile_active=None) -> list:
    act = [] if tile_active is None else [tile_active]
    return [bb.rows_local, bb.cols_local, bb.vals, bb.tile_cb, bb.tile_cnt,
            bb.tile_rb, bb.rb_ptr, *act]


def _on_cpu(bb: BBCSR, x: Optional[torch.Tensor], tile_active=None) -> bool:
    """True when every operand lies on the CPU, False when all lie on one
    CUDA device; a mix raises."""
    return _build.on_cpu(_operands(bb, tile_active) + [x], "BBCSR")


def share_size(total: int, shares: int = SHARES) -> int:
    """Live slots per share for ``total`` live slots (as bbcsr.cu sizes
    them): total / shares, rounded up to 32, within [SHARE_MIN,
    SHARE_MAX]."""
    per = -(-total // shares)
    return min(SHARE_MAX, max(SHARE_MIN, -(-per // 32) * 32))


def _max_chunks(bb: BBCSR) -> int:
    """The most shares any plan of ``bb`` holds: at most SHARES while the
    share is not held down by SHARE_MAX, and never more than one per
    SHARE_MIN slots."""
    return min(max(SHARES, -(-bb.nnz // SHARE_MAX)), -(-bb.nnz // SHARE_MIN))


def _check_operand(bb: BBCSR) -> None:
    if bb.tile_cnt is None or bb.rb_ptr is None or bb.nnz is None:
        raise ValueError("the BBCSR kernels need tile_cnt, rb_ptr and nnz: "
                         "build the operand with to_bbcsr or "
                         "bbcsr_from_numpy")
    n_t, T = bb.n_tiles, bb.tile_nnz
    if n_t == 0:
        raise ValueError("the operand has no tiles")
    want = {"rows_local": (torch.int32, (n_t, T)),
            "cols_local": (torch.int32, (n_t, T)),
            "vals": (torch.float32, (n_t, T)),
            "tile_rb": (torch.int32, (n_t,)),
            "tile_cb": (torch.int32, (n_t,)),
            "tile_cnt": (torch.int32, (n_t,)),
            "rb_ptr": (torch.int32, (bb.n_row_blocks + 1,))}
    for name, (dtype, shape) in want.items():
        t = getattr(bb, name)
        if t.dtype != dtype or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(f"bb.{name}: want contiguous {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    smem = _lib().bbcsr_smem_bytes(bb.block_rows)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"block_rows={bb.block_rows} needs {smem} B of "
                         f"shared memory per CTA, over {_SMEM_LIMIT}")


def _checked(bb: BBCSR) -> dict:
    """The operand's entry in _OPERANDS, checking it on first sight."""
    key = id(bb)
    entry = _OPERANDS.get(key)
    if entry is None:
        _check_operand(bb)
        entry = {"plan": None}
        _OPERANDS[key] = entry
        weakref.finalize(bb, _OPERANDS.pop, key, None)
    return entry


def _check_call(bb: BBCSR, x: Optional[torch.Tensor],
                tile_active=None) -> None:
    n_t = bb.n_tiles
    if tile_active is not None and (
            tile_active.dtype != torch.int32
            or tuple(tile_active.shape) != (n_t,)
            or not tile_active.is_contiguous()):
        raise ValueError(f"tile_active: want contiguous int32 ({n_t},), got "
                         f"{tile_active.dtype} {tuple(tile_active.shape)}")
    if x is not None and (x.dim() != 1 or
                          x.shape[0] > bb.n_col_blocks * bb.block_cols):
        raise ValueError(f"x: want a vector of at most "
                         f"{bb.n_col_blocks * bb.block_cols} entries, got "
                         f"{tuple(x.shape)}")


def _plan_sizes(bb: BBCSR) -> list:
    """Lengths of the work arrays, in the order bbcsr.cu lays them out:
    gsum, list_tile, list_ptr, chunk_first, rb_slot, meta."""
    n_t = bb.n_tiles
    return [2 * -(-n_t // _PLAN_TILES), n_t, n_t + 1, _max_chunks(bb) + 1,
            bb.n_row_blocks + 1, 3]


def _launch_plan(bb: BBCSR, tile_active=None) -> Plan:
    """Build the plan on the card, over one work tensor."""
    work = torch.empty(sum(_plan_sizes(bb)), dtype=torch.int32,
                       device=bb.tile_cnt.device)
    gsum, *plan_arrays = torch.split(work, _plan_sizes(bb))
    act = 0 if tile_active is None else tile_active.data_ptr()
    _build.launch(_lib().bbcsr_plan, work.device, bb.tile_cnt.data_ptr(), act,
                  bb.tile_rb.data_ptr(), bb.n_tiles, bb.n_row_blocks, SHARES,
                  SHARE_MIN, SHARE_MAX, gsum.data_ptr(),
                  *[a.data_ptr() for a in plan_arrays], what="bbcsr_plan")
    return Plan(*plan_arrays)


def plan_ref(bb: BBCSR, tile_active: Optional[torch.Tensor] = None, *,
             shares: int = SHARES) -> Plan:
    """The plain version of the plan, every array cut to its length."""
    cnt = bb.tile_cnt.long()
    live = cnt > 0
    if tile_active is not None:
        live &= tile_active != 0
    c = torch.where(live, cnt, 0)
    excl = torch.cumsum(c, 0) - c
    total = int(c.sum())
    share = share_size(total, shares)
    list_tile = torch.nonzero(live).squeeze(1)
    n_list = int(list_tile.numel())
    tail = excl.new_tensor([total])
    list_ptr = torch.cat([excl[list_tile], tail])
    n_chunks = -(-total // share)
    starts = torch.arange(n_chunks, device=cnt.device) * share
    chunk_first = torch.cat([
        torch.searchsorted(list_ptr, starts, right=True) - 1,
        excl.new_tensor([n_list])])
    rb_slot = torch.cat([excl[bb.rb_ptr[:-1].long()], tail])
    return Plan(*(a.to(torch.int32) for a in (
        list_tile, list_ptr, chunk_first, rb_slot,
        excl.new_tensor([n_list, n_chunks, share]))))


def plan(bb: BBCSR, tile_active: Optional[torch.Tensor] = None) -> Plan:
    """The schedule the kernels run: on CUDA tensors built by the plan
    kernels (the buffers, valid up to ``meta``), on CPU tensors its plain
    version."""
    if _on_cpu(bb, None, tile_active):
        return plan_ref(bb, tile_active)
    _checked(bb)
    _check_call(bb, None, tile_active)
    return _launch_plan(bb, tile_active)


def _product(entry: str, bb: BBCSR, x: torch.Tensor, combine: str,
             tile_active=None) -> torch.Tensor:
    known = _checked(bb)
    _check_call(bb, x, tile_active)
    if x.dtype != torch.float32 or not x.is_contiguous():
        x = x.to(torch.float32).contiguous()
    dev = x.device
    y = torch.empty(bb.n_rows, dtype=torch.float32, device=dev)
    max_chunks = _max_chunks(bb)
    scratch = torch.empty(2 * max_chunks * bb.block_rows,
                          dtype=torch.float32, device=dev)
    geom = [bb.block_rows, bb.block_cols, bb.tile_nnz]
    tiles = [t.data_ptr() for t in (bb.rows_local, bb.cols_local, bb.vals,
                                    bb.tile_cb)]
    if tile_active is None:
        if known["plan"] is None:
            known["plan"] = _launch_plan(bb)
        p = [t.data_ptr() for t in known["plan"]]
        _build.launch(_lib().bbcsr_spmv, dev, *tiles, bb.tile_rb.data_ptr(),
                      *p, x.data_ptr(), x.shape[0], y.data_ptr(),
                      scratch.data_ptr(), bb.n_rows, bb.n_row_blocks, *geom,
                      max_chunks, what=entry)
    else:
        work = torch.empty(sum(_plan_sizes(bb)), dtype=torch.int32,
                           device=dev)
        _build.launch(_lib().bbcsr_spmspv, dev, *tiles,
                      bb.tile_cnt.data_ptr(), bb.tile_rb.data_ptr(),
                      tile_active.data_ptr(), x.data_ptr(), x.shape[0],
                      y.data_ptr(), work.data_ptr(), scratch.data_ptr(),
                      bb.n_rows, bb.n_tiles, bb.n_row_blocks, *geom, SHARES,
                      SHARE_MIN, SHARE_MAX, max_chunks,
                      _COMBINE_CODE[combine], what=entry)
    LAUNCHES[entry] += 1
    return y


def spmv_bbcsr_kernel_call(bb: BBCSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over every tile.  Returns (n_rows,) float32."""
    if _on_cpu(bb, x):
        return ref.spmv_bbcsr_ref(bb, x)
    return _product("spmv_bbcsr", bb, x, "add")


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
    return _product(entry, bb, x, combine, tile_active)
