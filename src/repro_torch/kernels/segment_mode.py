"""Weighted label mode and in-order run sums: torch wrappers of the CUDA
kernels in ``csrc/segment_mode.cu``.

Counterpart of ``repro.core.offload.segment_weighted_mode`` (plain jnp
there, no Pallas kernel) after its sort, and of the in-order
``jax.ops.segment_sum`` over a sorted stream that ``graph.contract`` and the
Louvain gain gate run.  Given CPU tensors a wrapper computes the plain
version (:func:`.ref.segment_mode_ref`, :func:`.ref.run_sum_ref`); given
CUDA tensors it launches the kernel or raises.  Each launch adds one to its
entry of :data:`LAUNCHES`.  Both add each run's weights in stream order in
f32, so the kernels' outputs equal the plain versions' bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref

__all__ = ["segment_mode_kernel_call", "run_sum_kernel_call", "LAUNCHES",
           "reset_launches"]

# kernel launches since the last reset_launches()
LAUNCHES = {"segment_mode": 0, "run_sum": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("segment_mode")
    if not getattr(lib, "_argtypes_set", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        # dst, label, w, m, n, ptr, best_w, best_l, stream
        lib.segment_mode.argtypes = [P, P, P, L, I, P, P, P, P]
        lib.segment_mode.restype = ctypes.c_int
        # idx, w, m, n, ptr, out, stream
        for fn in (lib.run_sum, lib.run_sum_f64):
            fn.argtypes = [P, P, L, I, P, P, P]
            fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _check_stream(what: str, idx: torch.Tensor, *rest: torch.Tensor) -> None:
    if idx.dim() != 1 or any(t.shape != idx.shape for t in rest):
        raise ValueError(f"{what}: want 1-d streams of one length, got "
                         f"{[tuple(t.shape) for t in (idx,) + rest]}")
    if idx.is_floating_point():
        raise ValueError(f"{what} takes integer ids")


def segment_mode_kernel_call(dst: torch.Tensor, label: torch.Tensor,
                             w: torch.Tensor, n: int):
    """(best_w (n,) f32, best_label (n,) int32) over a stream sorted by
    (dst, label) with labels >= 0: per destination the label whose run of
    weights sums highest, added in stream order (ties to the smaller label;
    a label >= LABEL_PAD reads -1, as in the reference's label plane), and
    (-inf, -1) where no run sums above -inf.  Destinations outside [0, n)
    are ignored."""
    _check_stream("segment_mode", dst, label, w)
    if label.is_floating_point():
        raise ValueError("segment_mode takes integer labels")
    if _build.on_cpu((dst, label, w), "segment_mode"):
        return ref.segment_mode_ref(dst, label, w, n)
    dev = w.device
    dst = dst.to(torch.int32).contiguous()
    label = label.to(torch.int32).contiguous()
    w = w.to(torch.float32).contiguous()
    best_w = torch.empty(n, dtype=torch.float32, device=dev)
    best_l = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return best_w, best_l
    ptr = torch.empty(n + 1, dtype=torch.int64, device=dev)
    _build.launch(_lib().segment_mode, dev, dst.data_ptr(), label.data_ptr(),
                  w.data_ptr(), dst.numel(), n, ptr.data_ptr(),
                  best_w.data_ptr(), best_l.data_ptr(), what="segment_mode")
    LAUNCHES["segment_mode"] += 1
    return best_w, best_l


def run_sum_kernel_call(idx: torch.Tensor, w: torch.Tensor,
                        n: int) -> torch.Tensor:
    """out (n,): out[v] = the weights of the items with idx == v added in
    stream order from 0, over a stream sorted by idx, in f32 — or in f64
    when ``w`` is float64; ids outside [0, n) are ignored, a destination
    with no items gets 0."""
    _check_stream("run_sum", idx, w)
    dtype = torch.float64 if w.dtype == torch.float64 else torch.float32
    if _build.on_cpu((idx, w), "run_sum"):
        return ref.run_sum_ref(idx, w, n)
    dev = w.device
    idx = idx.to(torch.int32).contiguous()
    w = w.to(dtype).contiguous()
    out = torch.empty(n, dtype=dtype, device=dev)
    if n == 0:
        return out
    ptr = torch.empty(n + 1, dtype=torch.int64, device=dev)
    lib = _lib()
    _build.launch(lib.run_sum_f64 if dtype == torch.float64 else lib.run_sum,
                  dev, idx.data_ptr(), w.data_ptr(), idx.numel(), n,
                  ptr.data_ptr(), out.data_ptr(), what="run_sum")
    LAUNCHES["run_sum"] += 1
    return out
