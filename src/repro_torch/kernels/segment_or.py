"""Segment OR: torch wrappers of the CUDA kernels in ``csrc/segment_or.cu``.

Counterparts of ``repro.core.offload.segment_or`` (plain jnp there, no
Pallas kernel): :func:`segment_or_kernel_call` on a stream of ids in any
order, and :func:`segment_or_rows_kernel_call` on a stream sorted by
destination in CSR form, with the row gather fused in (MS-BFS's dense
step).  Given CPU tensors a wrapper computes its plain version
(:func:`.ref.segment_or_ref`, :func:`.ref.segment_or_rows_ref`); given CUDA
tensors it launches the kernel or raises.  Each launch adds one to its
entry's count in :data:`LAUNCHES`.  OR does not depend on order, so each
kernel's output equals its plain version's bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref

__all__ = ["segment_or_kernel_call", "segment_or_rows_kernel_call",
           "LAUNCHES", "reset_launches"]

# kernel launches since the last reset_launches(), by entry
LAUNCHES = {"segment_or": 0, "segment_or_rows": 0}
_INT32_MAX = 2 ** 31 - 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("segment_or")
    if not getattr(lib, "_argtypes_set", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        # idx, words, out, m, W, n, stream
        lib.segment_or.argtypes = [P, P, P, L, I, I, P]
        lib.segment_or.restype = ctypes.c_int
        # offsets, src, msg, split, out, n, m, W, t_rows, stream
        lib.segment_or_rows.argtypes = [P, P, P, P, P, I, L, I, I, P]
        lib.segment_or_rows.restype = ctypes.c_int
        lib.segment_or_rows_shares.argtypes = [I, L]
        lib.segment_or_rows_shares.restype = ctypes.c_int64
        lib._argtypes_set = True
    return lib


def segment_or_kernel_call(idx: torch.Tensor, words: torch.Tensor,
                           n: int) -> torch.Tensor:
    """out (n, W) int32: out[v] = OR of the rows of words (m, W) with
    idx == v; ids outside [0, n) are dropped.  Any order of ids: the kernel
    merges equal ids that fall in one warp, so ids sorted by destination
    only mean fewer atomics."""
    if idx.dim() != 1 or words.dim() != 2 or words.shape[0] != idx.shape[0]:
        raise ValueError(f"want idx (m,) and words (m, W), got "
                         f"{tuple(idx.shape)} and {tuple(words.shape)}")
    if idx.is_floating_point() or words.is_floating_point():
        raise ValueError("segment_or takes integer ids and words")
    if _build.on_cpu((idx, words), "segment_or"):
        return ref.segment_or_ref(idx, words, n)
    idx = idx.to(torch.int32).contiguous()
    words = words.to(torch.int32).contiguous()
    m, w_per = words.shape
    out = torch.zeros((n, w_per), dtype=torch.int32, device=words.device)
    if out.numel() == 0 or words.numel() == 0:
        return out
    _build.launch(_lib().segment_or, words.device, idx.data_ptr(),
                  words.data_ptr(), out.data_ptr(), m, w_per, n,
                  what="segment_or")
    LAUNCHES["segment_or"] += 1
    return out


def segment_or_rows_kernel_call(offsets: torch.Tensor, src: torch.Tensor,
                                msg: torch.Tensor, n: int) -> torch.Tensor:
    """out (n, W) int32: out[v] = OR of the rows of msg (T, W) named by
    src[j] for j in [offsets[v], offsets[v + 1]); a src[j] outside [0, T)
    adds nothing, a row with no items is 0.  offsets (n + 1,)
    non-decreasing, offsets[n] at most len(src); int32 offsets and sources
    are read as they are (the engine keeps them so per CSR).  One call of
    the C entry (a plan pass, then the row pass): the gather is fused in,
    no (m, W) words are written."""
    if offsets.dim() != 1 or offsets.numel() != n + 1 or src.dim() != 1 \
            or msg.dim() != 2:
        raise ValueError(f"want offsets ({n + 1},), src (m,) and msg (T, W),"
                         f" got {tuple(offsets.shape)}, {tuple(src.shape)} "
                         f"and {tuple(msg.shape)}")
    if offsets.is_floating_point() or src.is_floating_point() or \
            msg.is_floating_point():
        raise ValueError("segment_or_rows takes integer offsets, sources "
                         "and words")
    if _build.on_cpu((offsets, src, msg), "segment_or_rows"):
        return ref.segment_or_rows_ref(offsets, src, msg, n)
    if max(n + 1, src.numel(), msg.shape[0]) > _INT32_MAX:
        raise ValueError("segment_or_rows: n, m and the table's rows must "
                         "fit int32")
    offsets = offsets.to(torch.int32).contiguous()
    src = src.to(torch.int32).contiguous()
    msg = msg.to(torch.int32).contiguous()
    t_rows, w_per = msg.shape
    # every row of out is written by the kernel
    out = torch.empty((n, w_per), dtype=torch.int32, device=msg.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    # where each merge-path share starts: the plan pass writes it
    split = torch.empty(lib.segment_or_rows_shares(n, src.numel()),
                        dtype=torch.int32, device=msg.device)
    _build.launch(lib.segment_or_rows, msg.device, offsets.data_ptr(),
                  src.data_ptr(), msg.data_ptr(), split.data_ptr(),
                  out.data_ptr(), n, src.numel(), w_per, t_rows,
                  what="segment_or_rows")
    LAUNCHES["segment_or_rows"] += 1
    return out
