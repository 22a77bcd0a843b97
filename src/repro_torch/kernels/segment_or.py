"""Segment OR: torch wrapper of the CUDA kernel in ``csrc/segment_or.cu``.

Counterpart of ``repro.core.offload.segment_or`` (plain jnp there, no
Pallas kernel).  Given CPU tensors the wrapper computes the plain version
(:func:`.ref.segment_or_ref`); given CUDA tensors it launches the kernel or
raises.  Each launch adds one to :data:`LAUNCHES`.  OR does not depend on
order, so the kernel's output equals the plain version's bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref

__all__ = ["segment_or_kernel_call", "LAUNCHES", "reset_launches"]

# kernel launches since the last reset_launches()
LAUNCHES = {"segment_or": 0}


def reset_launches() -> None:
    LAUNCHES["segment_or"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("segment_or")
    if not getattr(lib, "_argtypes_set", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        # idx, words, out, m, W, n, stream
        lib.segment_or.argtypes = [P, P, P, L, I, I, P]
        lib.segment_or.restype = ctypes.c_int
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
