"""Weighted label mode and in-order run sums: torch wrappers of the CUDA
kernels in ``csrc/segment_mode.cu``.

Counterpart of ``repro.core.offload.segment_weighted_mode`` (plain jnp
there, no Pallas kernel) after its sort, and of the in-order
``jax.ops.segment_sum`` over a sorted stream that ``graph.contract`` and the
Louvain gain gate run.  Given CPU tensors a wrapper computes the plain
version (:func:`.ref.segment_mode_ref`, :func:`.ref.run_sum_ref`); given
CUDA tensors it launches the kernel or raises.  Each launch adds one to its
entry of :data:`LAUNCHES` (one a call, whatever passes it takes).  Both
add each run's weights in stream order in f32, so the kernels' outputs equal
the plain versions' bit for bit.

The kernels split the work by run length: a CTA takes :data:`TILE` items
and adds every run starting there from shared memory, one thread a run; a
run longer than :data:`LONG_RUN` items streams through a ring in shared
memory to one thread of its own CTA.  The mode then picks each
destination's best run in a second pass, by comparisons only.  int32 ids
take the int32 entries, and any other ids are read as int64, with no pass
that casts them.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref

__all__ = ["segment_mode_kernel_call", "run_sum_kernel_call", "LAUNCHES",
           "reset_launches", "TILE", "LONG_RUN"]

# the kernels' kTile and kLongRun (csrc/segment_mode.cu): the items a CTA
# takes, and the longest run it adds from its window in shared memory
TILE = 2048
LONG_RUN = 2048

# kernel launches since the last reset_launches()
LAUNCHES = {"segment_mode": 0, "run_sum": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("segment_mode")
    if not getattr(lib, "_argtypes_set", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for ids in ("", "_i64"):
            # dst, label, w, m, n, ptr, recs, bits, best_w, best_l, stream
            fn = getattr(lib, "segment_mode" + ids)
            fn.argtypes = [P, P, P, L, I, P, P, P, P, P, P]
            fn.restype = ctypes.c_int
            # idx, w, m, n, ptr, out, stream
            for name in ("run_sum", "run_sum_f64"):
                fn = getattr(lib, name + ids)
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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels read it
    in 16-byte vectors); a copy where a view starts between two."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ids(*ids: torch.Tensor):
    """The id streams in the kernels' id type, and the C entries' suffix:
    int32 where each is int32, else int64 (an int64 stream is read as it
    is, with no pass that casts it)."""
    if all(t.dtype == torch.int32 for t in ids):
        return "", [_aligned(t) for t in ids]
    return "_i64", [_aligned(t.to(torch.int64)) for t in ids]


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
    ids, (dst, label) = _ids(dst, label)
    w = _aligned(w.to(torch.float32))
    best_w = torch.empty(n, dtype=torch.float32, device=dev)
    best_l = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return best_w, best_l
    m = dst.numel()
    ptr = torch.empty(n + 1, dtype=torch.int64, device=dev)
    # each run's (sum, label) at its first item, and a start flag an item
    recs = torch.empty(m, dtype=torch.int64, device=dev)
    bits = torch.empty(m // 32 + 2, dtype=torch.int32, device=dev)
    _build.launch(getattr(_lib(), "segment_mode" + ids), dev,
                  dst.data_ptr(), label.data_ptr(), w.data_ptr(), m, n,
                  ptr.data_ptr(), recs.data_ptr(), bits.data_ptr(),
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
    ids, (idx,) = _ids(idx)
    w = _aligned(w.to(dtype))
    out = torch.empty(n, dtype=dtype, device=dev)
    if n == 0:
        return out
    ptr = torch.empty(n + 1, dtype=torch.int64, device=dev)
    name = ("run_sum_f64" if dtype == torch.float64 else "run_sum") + ids
    _build.launch(getattr(_lib(), name),
                  dev, idx.data_ptr(), w.data_ptr(), idx.numel(), n,
                  ptr.data_ptr(), out.data_ptr(), what="run_sum")
    LAUNCHES["run_sum"] += 1
    return out
