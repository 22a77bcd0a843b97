"""Segment sum: torch wrapper of the CUDA kernel in ``csrc/segment_sum.cu``.

Counterpart of ``repro.kernels.segment_sum``.  The kernel is a CSR row
reduction with an optional row gather,
``out[s] = sum over j in [offsets[s], offsets[s + 1]) of table[rows[j]]``,
and :class:`SegmentPlan` turns a segment-id stream into that form (its
``perm`` and ``offsets``).  Given CPU tensors the wrappers compute the
plain versions (:func:`.ref.segment_sum_csr_ref`,
:func:`.ref.segment_sum_ref`); given CUDA tensors they launch the kernel or
raise.  The launch is also the CUDA kernel of the torch operator
``repro_torch::segment_sum_csr`` (:data:`segment_sum_op`), which the
wrappers call only on meta tensors: its meta kernel lets a dry run trace
them, while a CUDA call launches directly, without the dispatcher's cost.
Each launch adds one to :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from . import cost
from . import ref

__all__ = ["SegmentPlan", "segment_sum_csr_call", "segment_sum_kernel_call",
           "segment_sum_op", "entries_of", "split_rows", "LAUNCHES",
           "reset_launches"]

# kernel launches since the last reset_launches()
LAUNCHES = {"segment_sum": 0}


def reset_launches() -> None:
    LAUNCHES["segment_sum"] = 0


class SegmentPlan:
    """A segment-id stream ``seg`` (E,) over ``n`` segments in the CSR form
    the kernel reads, built at first use and kept: ``perm`` (E,) int32, the
    stream's positions in segment order (one stable sort of the ids; None
    where the ids are in order already), and ``offsets`` (n + 1,) int64, the
    start of each segment's run in that order (a search of the sorted ids).
    Ids outside [0, n), such as -1, are dropped: they sort last, past
    ``offsets[n]``."""

    __slots__ = ("seg", "n", "_csr")

    def __init__(self, seg: torch.Tensor, n: int):
        self.seg, self.n, self._csr = seg, int(n), None

    def _build(self):
        if self._csr is None:
            seg, n = self.seg, self.n
            keys = torch.where((seg >= 0) & (seg < n), seg, n).to(torch.int32)
            perm = None
            # meta ids (a dry run) cannot be read: they take the branch
            # that does the most work on the card, the sort
            if keys.numel() > 1 and (keys.is_meta or not bool(
                    (keys[1:] >= keys[:-1]).all())):
                keys, perm = torch.sort(keys, stable=True)
                perm = perm.to(torch.int32)
            # offsets[s] = the count of keys below s, searched in the sorted
            # keys: a histogram's atomics would serialise on a hub's id
            bounds = torch.arange(n + 1, dtype=torch.int32, device=seg.device)
            offsets = torch.searchsorted(keys, bounds)
            self._csr = (perm, offsets)
        return self._csr

    @property
    def perm(self) -> Optional[torch.Tensor]:
        return self._build()[0]

    @property
    def offsets(self) -> torch.Tensor:
        return self._build()[1]


def split_rows(offsets: torch.Tensor, block_n: int) -> int:
    """How many rows of ``offsets`` the kernel sums in pieces at block_n:
    those whose items (entries and end) straddle two merge-path shares of
    block_n items (the kernel's rule, for tests and logs)."""
    o = offsets.long() - offsets[0].long()
    r = torch.arange(o.numel() - 1, device=o.device)
    return int(((r + o[:-1]) // block_n != (r + o[1:]) // block_n).sum())


def _lib() -> ctypes.CDLL:
    lib = _build.load("segment_sum")
    if not getattr(lib, "_argtypes_set", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        # table, rows, offsets, out, part, tail, m, t_rows, d, share,
        # n_groups, vec, stream
        lib.segment_sum_csr.argtypes = [P, P, P, P, P, P, L, L, I, L, L, I,
                                        P]
        lib.segment_sum_csr.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def entries_of(table_shape, rows_shape) -> int:
    """The entries one B4 call walks at most: len(rows), or the table's
    rows without a gather (as the launch sizes its scratch)."""
    return table_shape[0] if rows_shape is None else rows_shape[0]


def _segment_sum_csr_launch(table: torch.Tensor, offsets: torch.Tensor,
                            rows: Optional[torch.Tensor],
                            block_n: int) -> torch.Tensor:
    """The launch on the card (also the operator's CUDA kernel)."""
    if block_n < 1:
        raise ValueError(f"block_n must be positive, got {block_n}")
    table = table.to(torch.float32).contiguous()
    offsets = offsets.to(torch.int64).contiguous()
    if rows is not None:
        rows = rows.to(torch.int32).contiguous()
    m = offsets.numel() - 1
    t, d = table.shape
    dev = table.device
    out = torch.empty((m, d), dtype=torch.float32, device=dev)
    # the entries offsets can name bound the path's length, so the scratch
    # is sized without reading offsets[m] back
    entries = entries_of(table.shape, None if rows is None else rows.shape)
    n_groups = max(1, -(-(m + entries) // block_n))
    vec = 4 if d % 4 == 0 and table.data_ptr() % 16 == 0 else 1
    part = torch.empty((n_groups, 2, d), dtype=torch.float32, device=dev)
    tail = torch.empty(n_groups, dtype=torch.int64, device=dev)
    _build.launch(_lib().segment_sum_csr, dev, table.data_ptr(),
                  None if rows is None else rows.data_ptr(),
                  offsets.data_ptr(), out.data_ptr(), part.data_ptr(),
                  tail.data_ptr(), m, t, d, block_n, n_groups, vec,
                  what="segment_sum")
    LAUNCHES["segment_sum"] += 1
    return out


# B4 as a torch operator: its CUDA kernel is the launch above, its meta
# kernel gives the output's shape, and torch.utils.flop_counter counts it
# by ``cost`` (a dry run traces it on meta tensors, ``launch.dryrun``)
segment_sum_op = torch.library.custom_op(
    "repro_torch::segment_sum_csr", _segment_sum_csr_launch, mutates_args=(),
    device_types="cuda",
    schema="(Tensor table, Tensor offsets, Tensor? rows, int block_n) "
           "-> Tensor")


@segment_sum_op.register_fake
def _(table, offsets, rows, block_n):
    return table.new_empty((offsets.shape[0] - 1, table.shape[1]),
                           dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.segment_sum_csr)
def _(table_shape, offsets_shape, rows_shape, block_n, *args, **kwargs):
    return cost.segment_sum_flops(entries_of(table_shape, rows_shape),
                                  table_shape[1])


def segment_sum_csr_call(table: torch.Tensor, offsets: torch.Tensor,
                         rows: Optional[torch.Tensor] = None, *,
                         block_n: int) -> torch.Tensor:
    """out (M, d) float32 for offsets (M + 1,) non-decreasing: out[s] = the
    sum, in the order of j, of table (T, d) rows rows[j] (None: row j) for
    j in [offsets[s], offsets[s + 1]); a rows[j] outside [0, T) adds 0, an
    empty segment is 0.  offsets[M] must not pass len(rows) (T where rows
    is None).  block_n: the rows plus entries one group of lanes walks (its
    merge-path share), so the longest piece of one output row summed before
    the row is split.  Bit-reproducible for equal inputs and block_n.
    CPU tensors take the plain version, CUDA tensors the launch, meta
    tensors (a dry run) the operator ``segment_sum_op``."""
    if table.dim() != 2 or offsets.dim() != 1 or offsets.numel() < 1 or \
            (rows is not None and rows.dim() != 1):
        raise ValueError(f"want table (T, d), offsets (M + 1,) and rows (E,)"
                         f" or None, got {tuple(table.shape)}, "
                         f"{tuple(offsets.shape)} and "
                         f"{None if rows is None else tuple(rows.shape)}")
    if _build.on_meta((table, offsets, rows)):
        return segment_sum_op(table, offsets, rows, int(block_n))
    if _build.on_cpu((table, offsets, rows), "segment_sum"):
        return ref.segment_sum_csr_ref(table, offsets, rows)
    return _segment_sum_csr_launch(table, offsets, rows, block_n)


def segment_sum_kernel_call(data: torch.Tensor, seg: torch.Tensor,
                            num_segments: int, *,
                            block_n: int) -> torch.Tensor:
    """out (num_segments, d) float32: out[s] = the sum of the rows of data
    (N, d) with seg == s; ids outside [0, num_segments), such as -1, are
    dropped.  On CUDA (and meta) tensors a plan of seg, then the kernel on
    data's rows in plan order."""
    if data.dim() != 2 or seg.shape != (data.shape[0],):
        raise ValueError(f"want data (N, d) and seg (N,), got "
                         f"{tuple(data.shape)} and {tuple(seg.shape)}")
    if not _build.on_meta((data, seg)) and \
            _build.on_cpu((data, seg), "segment_sum"):
        return ref.segment_sum_ref(data, seg, num_segments)
    plan = SegmentPlan(seg, num_segments)
    return segment_sum_csr_call(data, plan.offsets, plan.perm,
                                block_n=block_n)
