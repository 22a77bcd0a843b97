"""EmbeddingBag: torch wrapper of the CUDA kernel in
``csrc/embedding_bag.cu``.

Counterpart of ``repro.kernels.embedding_bag``.  Given CPU tensors the
wrapper computes the plain version (:func:`.ref.embedding_bag_ref`); given
CUDA tensors it launches the kernel or raises.  Each call adds one to
:data:`LAUNCHES`.  The stream must be sorted by bag; a bag may be empty
(its row comes out 0).  Unlike the TPU kernel, which returns sums and
leaves 'mean' to ``ops``, the kernel also divides for 'mean', by the sum
of the weights of the bag's valid lookups, which it sums in the same pass.

Summation order.  The kernel cuts the stream into chunks of :data:`CHUNK`
lookups and each chunk into pieces, the maximal runs of one bag inside it
(:func:`bag_pieces`).  A piece's weighted rows are summed in stream order
in float32, starting from 0; a bag's pieces, more than one only where the
bag crosses a chunk edge, are then added in chunk order.  The order is
fixed, so two calls on the same inputs give the same bits;
:func:`.ref.embedding_bag_pieces_ref` computes the same sums in the same
order.  The bag boundaries are found inside the kernel, so the call needs
no offsets array.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from . import ref

__all__ = ["embedding_bag_kernel_call", "bag_pieces", "CHUNK", "LAUNCHES",
           "reset_launches"]

# lookups per chunk, one CTA each (kChunk in csrc/embedding_bag.cu)
CHUNK = 512

# kernel calls since the last reset_launches()
LAUNCHES = {"embedding_bag": 0}


def reset_launches() -> None:
    LAUNCHES["embedding_bag"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("embedding_bag")
    if not getattr(lib, "_argtypes_set", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        # table, idx, w, bag, out, part, n, n_bags, d, n_rows, mean, stream
        lib.embedding_bag.argtypes = [P] * 6 + [L, L, I, L, I, P]
        lib.embedding_bag.restype = ctypes.c_int
        lib.embedding_bag_chunk.restype = ctypes.c_int
        lib.embedding_bag_scratch.argtypes = [L, I]
        lib.embedding_bag_scratch.restype = L
        if lib.embedding_bag_chunk() != CHUNK:
            raise RuntimeError("csrc/embedding_bag.cu cuts the stream into "
                               f"chunks of {lib.embedding_bag_chunk()}, the "
                               f"wrapper expects {CHUNK}")
        lib._argtypes_set = True
    return lib


def bag_pieces(bag: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """Starts of the pieces the kernel sums, in stream order: a piece
    begins at every chunk edge (a multiple of ``chunk``) and wherever the
    bag changes, and runs to the next start (the last to the stream's
    end)."""
    n = bag.shape[0]
    pos = torch.arange(n, device=bag.device)
    new = pos % chunk == 0
    new[1:] |= bag[1:] != bag[:-1]
    return torch.nonzero(new).squeeze(1)


def embedding_bag_kernel_call(table: torch.Tensor, idx: torch.Tensor,
                              bag: torch.Tensor, n_bags: int,
                              weights: Optional[torch.Tensor] = None, *,
                              mode: str = "sum") -> torch.Tensor:
    """table (V, d); idx (N,) int, -1 = padding; bag (N,) int in
    [0, n_bags), non-decreasing; weights (N,) or None.  Returns (n_bags, d)
    float32: per bag the weighted sum of its rows ('sum') or that sum over
    the sum of its valid weights ('mean'), summed in the order the module
    docstring states."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    n = idx.shape[0]
    if table.dim() != 2 or idx.shape != (n,) or bag.shape != (n,) or (
            weights is not None and weights.shape != (n,)):
        raise ValueError("want table (V, d) and idx, bag, weights (N,)")
    if _build.on_cpu((table, idx, bag, weights), "embedding_bag"):
        return ref.embedding_bag_ref(table, idx, bag, n_bags, weights, mode)
    table, idx, bag = (_as(table, torch.float32), _as(idx, torch.int32),
                       _as(bag, torch.int32))
    w = None if weights is None else _as(weights, torch.float32)
    d = table.shape[1]
    lib = _lib()
    # one allocation: out, then the kernel's partial sums for the bags that
    # cross a chunk edge
    buf = torch.empty(n_bags * d + lib.embedding_bag_scratch(n, d),
                      dtype=torch.float32, device=table.device)
    _build.launch(lib.embedding_bag, table.device, table.data_ptr(),
                  idx.data_ptr(), None if w is None else w.data_ptr(),
                  bag.data_ptr(), buf.data_ptr(),
                  buf.data_ptr() + 4 * n_bags * d, n, n_bags, d,
                  table.shape[0], int(mode == "mean"), what="embedding_bag")
    LAUNCHES["embedding_bag"] += 1
    return buf.as_strided((n_bags, d), (d, 1))


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t as a contiguous tensor of dtype: t itself where it is one."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()
