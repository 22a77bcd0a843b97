"""Graph substrate on torch: CSR storage, RMAT synthesis, kernel formats.

The counterpart of ``repro.core.graph`` for the one-device query path:

* :class:`CSR` — compressed sparse rows, int32 structure, f32 values;
* :func:`rmat` / :func:`uniform_random_graph` — the same numpy generators as
  the reference (same seeds give the same bits), moved to the device at the
  end;
* padded-ELL rows (:func:`to_padded_ell`) and BBCSR tiles (:class:`BBCSR`,
  :func:`to_bbcsr`) — block-bucketed COO, nonzeros sorted by (row block,
  column block, row), each bucket padded to whole ``tile_nnz`` tiles, every
  row block holding at least one tile.

Every array is built on a torch device: CUDA unless the caller passes
``device="cpu"``.  Asking for CUDA on a host without a card raises; nothing
drops silently to the CPU.  The builders are vectorized over the nonzeros,
so host memory stays O(nnz) even where the padded tile array is not (907 M
slots at RMAT-20 on the default geometry), and their outputs are byte-equal
to the reference's arrays.

:func:`csr_from_numpy` and :func:`bbcsr_from_numpy` take the reference's
arrays as numpy, so both packages can run on identical operands.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["CSR", "BBCSR", "rmat", "uniform_random_graph", "to_padded_ell",
           "to_bbcsr", "csr_from_numpy", "bbcsr_from_numpy", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: CUDA unless ``device`` says
    otherwise.  A CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested (the default) but torch sees none; "
            "pass device='cpu' to build on the host")
    return dev


def _tensor(a, dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    a = np.asarray(a)
    if not a.flags.writeable:       # torch refuses to alias read-only memory
        a = a.copy()
    return torch.as_tensor(a, device=device).to(dtype)


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix / adjacency.

    indptr:  (n_rows+1,) int32
    indices: (nnz,) int32 column ids
    values:  (nnz,) float32 edge weights, or None (unit weights, handled by
             callers)

    Derived index arrays (row ids, their int64 forms for
    ``scatter_reduce_``) are memoized on the instance: the graph is
    immutable, and the engine reads them on every level.
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    values: Optional[torch.Tensor]
    n_rows: int
    n_cols: int
    _memo: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def row_ids(self) -> torch.Tensor:
        """(nnz,) int32 row id per nonzero (sorted); memoized."""
        hit = self._memo.get("row_ids")
        if hit is None:
            hit = torch.repeat_interleave(
                torch.arange(self.n_rows, dtype=torch.int32,
                             device=self.device),
                self.degrees().long(), output_size=self.nnz)
            self._memo["row_ids"] = hit
        return hit

    def index64(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(row ids, column ids) as int64, the index type
        ``scatter_reduce_`` takes; memoized so a run converts once."""
        hit = self._memo.get("index64")
        if hit is None:
            hit = (self.row_ids().long(), self.indices.long())
            self._memo["index64"] = hit
        return hit

    def to_dense(self) -> torch.Tensor:
        vals = self.values if self.values is not None else torch.ones(
            self.nnz, dtype=torch.float32, device=self.device)
        out = torch.zeros((self.n_rows, self.n_cols), dtype=vals.dtype,
                          device=self.device)
        rows, cols = self.index64()
        return out.index_put_((rows, cols), vals, accumulate=True)

    def transpose(self) -> "CSR":
        """A^T sharing A's vertex ids (the pull direction's in-edges), built
        on this CSR's device."""
        return CSR.from_coo(self.indices, self.row_ids(), self.values,
                            self.n_cols, self.n_rows, device=self.device)

    @staticmethod
    def from_coo(rows, cols, vals, n_rows, n_cols, *,
                 sum_duplicates: bool = False, device=None) -> "CSR":
        """COO -> CSR, entries ordered by (row, col) with ties in input
        order (the reference's stable lexsort).  ``sum_duplicates`` merges
        repeated (row, col) pairs, summing values in float64 in input order
        as ``np.bincount`` does, then rounding once to float32."""
        dev = resolve_device(device)
        rows = _tensor(rows, torch.int64, dev)
        cols = _tensor(cols, torch.int64, dev)
        if vals is not None:
            vals = _tensor(vals, torch.float64, dev)
        # lexsort((cols, rows)): stable by cols, then stable by rows
        order = torch.sort(cols, stable=True).indices
        order = order[torch.sort(rows[order], stable=True).indices]
        rows, cols = rows[order], cols[order]
        if vals is not None:
            vals = vals[order]
        if sum_duplicates and rows.numel():
            keep = torch.ones_like(rows, dtype=torch.bool)
            keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            if vals is not None:
                vals = _sum_runs(keep, vals)
            rows, cols = rows[keep], cols[keep]
        counts = torch.bincount(rows, minlength=n_rows)
        indptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
        indptr[1:] = torch.cumsum(counts, 0)
        return CSR(indptr.to(torch.int32), cols.to(torch.int32),
                   None if vals is None else vals.to(torch.float32),
                   int(n_rows), int(n_cols))


def _sum_runs(is_start: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Per-run float64 sums of ``vals`` (runs begin where ``is_start``),
    accumulated strictly in input order so the rounding matches a
    sequential ``np.bincount``: the j-th member of every run is added in
    pass j, and each pass touches every run at most once."""
    seg = torch.cumsum(is_start.long(), 0) - 1
    out = vals[is_start].clone()
    dup = torch.nonzero(~is_start).squeeze(1)
    if dup.numel() == 0:
        return out
    first = torch.nonzero(is_start).squeeze(1)
    pos = dup - first[seg[dup]]
    for j in range(1, int(pos.max()) + 1):
        sel = dup[pos == j]
        out.index_add_(0, seg[sel], vals[sel])
    return out


def rmat(scale: int, edge_factor: int = 16, *, a=0.57, b=0.19, c=0.19,
         seed: int = 0, weighted: bool = True, dedup: bool = True,
         device=None) -> CSR:
    """RMAT generator (Graph500 parameters by default), n = 2**scale.

    The edge draw is the reference's numpy code, so a seed gives the same
    bits in both packages; the CSR is assembled on ``device``.
    """
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    rows = np.zeros(m, np.int64)
    cols = np.zeros(m, np.int64)
    pa, pb, pc = a, b, c
    for bit in range(scale):
        r = rng.random(m)
        go_right = (r >= pa + pc) & (r < pa + pc + pb) | (r >= pa + pb + pc)
        go_down = (r >= pa) & (r < pa + pc) | (r >= pa + pb + pc)
        rows |= go_down.astype(np.int64) << bit
        cols |= go_right.astype(np.int64) << bit
    vals = rng.random(m).astype(np.float32) if weighted else None
    return CSR.from_coo(rows, cols, vals, n, n, sum_duplicates=dedup,
                        device=device)


def uniform_random_graph(n: int, avg_degree: int, *, seed: int = 0,
                         weighted: bool = True, device=None) -> CSR:
    rng = np.random.default_rng(seed)
    m = n * avg_degree
    rows = rng.integers(0, n, m)
    cols = rng.integers(0, n, m)
    vals = rng.random(m).astype(np.float32) if weighted else None
    return CSR.from_coo(rows, cols, vals, n, n, sum_duplicates=True,
                        device=device)


def csr_from_numpy(indptr, indices, values, n_rows, n_cols, *,
                   device=None) -> CSR:
    """The reference's CSR arrays (as numpy) -> a port CSR on ``device``."""
    dev = resolve_device(device)
    return CSR(_tensor(indptr, torch.int32, dev),
               _tensor(indices, torch.int32, dev),
               None if values is None else _tensor(values, torch.float32, dev),
               int(n_rows), int(n_cols))


# ---------------------------------------------------------------------------
# Kernel-facing formats
# ---------------------------------------------------------------------------

def to_padded_ell(csr: CSR, max_nnz_per_row: Optional[int] = None):
    """Pad each row to a fixed nonzero budget (rows longer than it are cut).

    Returns (cols (n_rows, k) int32, vals (n_rows, k) f32, mask (n_rows, k)
    bool); padding entries have col=0, val=0.
    """
    dev = csr.device
    deg = csr.degrees().long()
    k = int(max_nnz_per_row or (int(deg.max()) if deg.numel() else 0))
    vals = csr.values if csr.values is not None else torch.ones(
        csr.nnz, dtype=torch.float32, device=dev)
    rows, cols = csr.index64()
    pos = torch.arange(csr.nnz, device=dev) - csr.indptr.long()[rows]
    keep = pos < k
    r, p = rows[keep], pos[keep]
    out_c = torch.zeros((csr.n_rows, k), dtype=torch.int32, device=dev)
    out_v = torch.zeros((csr.n_rows, k), dtype=torch.float32, device=dev)
    mask = torch.zeros((csr.n_rows, k), dtype=torch.bool, device=dev)
    out_c[r, p] = cols[keep].to(torch.int32)
    out_v[r, p] = vals[keep].to(torch.float32)
    mask[r, p] = True
    return out_c, out_v, mask


@dataclasses.dataclass(frozen=True)
class BBCSR:
    """Block-bucketed sparse format for the BBCSR SpMV/SpMSpV kernels.

    Nonzeros are bucketed by (row block, column block) and sorted by
    (row_block, col_block, row); each bucket is padded to a multiple of
    ``tile_nnz``.  Tiles are ordered by row block, so each row block's tiles
    are one contiguous range, ``rb_ptr[b]:rb_ptr[b+1]``; a row block with no
    nonzeros holds one all-padding tile.

    rows_local / cols_local : (n_tiles, tile_nnz) int32, local to the block
    vals                    : (n_tiles, tile_nnz) f32 (0 on padding)
    tile_rb / tile_cb       : (n_tiles,) int32 owning row / column block
    tile_init               : (n_tiles,) int32, 1 on a row block's first tile
    tile_cnt                : (n_tiles,) int32 real nonzeros in the tile;
                              padding is always the tile's tail, so
                              ``slot < tile_cnt`` is the validity mask
    rb_ptr                  : (n_row_blocks+1,) int32 tile range per row
                              block (derived; the kernels walk it)
    """

    rows_local: torch.Tensor
    cols_local: torch.Tensor
    vals: torch.Tensor
    tile_rb: torch.Tensor
    tile_cb: torch.Tensor
    tile_init: torch.Tensor
    n_rows: int
    n_cols: int
    block_rows: int
    block_cols: int
    tile_nnz: int
    tile_cnt: Optional[torch.Tensor] = None
    rb_ptr: Optional[torch.Tensor] = None

    @property
    def n_tiles(self) -> int:
        return int(self.tile_rb.shape[0])

    @property
    def n_row_blocks(self) -> int:
        return -(-self.n_rows // self.block_rows)

    @property
    def n_col_blocks(self) -> int:
        return -(-self.n_cols // self.block_cols)


def _rb_ptr(tile_rb: torch.Tensor, n_row_blocks: int) -> torch.Tensor:
    counts = torch.bincount(tile_rb.long(), minlength=n_row_blocks)
    ptr = torch.zeros(n_row_blocks + 1, dtype=torch.int64,
                      device=tile_rb.device)
    ptr[1:] = torch.cumsum(counts, 0)
    return ptr.to(torch.int32)


def to_bbcsr(csr: CSR, *, block_rows: int = 256, block_cols: int = 512,
             tile_nnz: int = 512) -> BBCSR:
    """CSR -> BBCSR on the CSR's device (see the BBCSR docstring).

    One stable sort of the nonzeros by (row block, column block) — rows are
    already ascending — gives the reference's bucket order.  Each nonzero's
    destination (tile, slot) follows from its bucket's tile offset, which
    counts the tiles of earlier buckets plus the all-padding tiles of the
    empty row blocks before it; the nonzeros are then scattered into
    zero-filled (n_tiles, tile_nnz) arrays.
    """
    dev = csr.device
    T = int(tile_nnz)
    n_rb = -(-csr.n_rows // block_rows)
    n_cb = -(-csr.n_cols // block_cols)
    rows, cols = csr.index64()
    vals = csr.values if csr.values is not None else torch.ones(
        csr.nnz, dtype=torch.float32, device=dev)
    rb, cb = rows // block_rows, cols // block_cols
    key, order = torch.sort(rb * n_cb + cb, stable=True)
    rows, cols, vals, rb, cb = (a[order] for a in (rows, cols, vals, rb, cb))

    m = csr.nnz
    is_start = torch.ones(m, dtype=torch.bool, device=dev)
    is_start[1:] = key[1:] != key[:-1]
    starts = torch.nonzero(is_start).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_tensor([m])])[:starts.numel()]
    cnt = ends - starts                                  # (G,) per bucket
    n_t = (cnt + T - 1) // T
    g_rb, g_cb = rb[starts], cb[starts]

    rb_tiles = torch.zeros(n_rb, dtype=torch.int64, device=dev)
    rb_tiles.index_add_(0, g_rb, n_t)
    empty = rb_tiles == 0
    rb_tiles = torch.where(empty, torch.ones_like(rb_tiles), rb_tiles)
    rb_ptr = torch.zeros(n_rb + 1, dtype=torch.int64, device=dev)
    rb_ptr[1:] = torch.cumsum(rb_tiles, 0)
    n_tiles = int(rb_ptr[-1])
    empty_before = torch.cumsum(empty.long(), 0) - empty.long()
    g_off = torch.cumsum(n_t, 0) - n_t                   # among bucket tiles
    g_first = g_off + empty_before[g_rb]                 # final tile index

    gid = torch.cumsum(is_start.long(), 0) - 1
    p = torch.arange(m, device=dev) - starts[gid]
    flat = (g_first[gid] + p // T) * T + p % T
    rows_local = torch.zeros(n_tiles * T, dtype=torch.int32, device=dev)
    cols_local = torch.zeros(n_tiles * T, dtype=torch.int32, device=dev)
    t_vals = torch.zeros(n_tiles * T, dtype=torch.float32, device=dev)
    rows_local[flat] = (rows - rb * block_rows).to(torch.int32)
    cols_local[flat] = (cols - cb * block_cols).to(torch.int32)
    t_vals[flat] = vals.to(torch.float32)

    G = starts.numel()
    ggid = torch.repeat_interleave(torch.arange(G, device=dev), n_t)
    j = torch.arange(ggid.numel(), device=dev) - g_off[ggid]
    tile = g_first[ggid] + j
    tile_cb = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    tile_cnt = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    tile_cb[tile] = g_cb[ggid].to(torch.int32)
    tile_cnt[tile] = torch.clamp(cnt[ggid] - j * T, max=T).to(torch.int32)
    tile_rb = torch.repeat_interleave(
        torch.arange(n_rb, dtype=torch.int32, device=dev), rb_tiles,
        output_size=n_tiles)
    tile_init = torch.ones(n_tiles, dtype=torch.int32, device=dev)
    tile_init[1:] = (tile_rb[1:] != tile_rb[:-1]).to(torch.int32)
    return BBCSR(rows_local.view(n_tiles, T), cols_local.view(n_tiles, T),
                 t_vals.view(n_tiles, T), tile_rb, tile_cb, tile_init,
                 csr.n_rows, csr.n_cols, block_rows, block_cols, T,
                 tile_cnt=tile_cnt, rb_ptr=rb_ptr.to(torch.int32))


def bbcsr_from_numpy(fields: dict, *, device=None) -> BBCSR:
    """The reference's BBCSR fields (arrays as numpy, geometry as ints) ->
    a port BBCSR on ``device``; ``rb_ptr`` is derived from ``tile_rb``."""
    dev = resolve_device(device)
    arrays = {k: _tensor(fields[k], torch.float32 if k == "vals"
                         else torch.int32, dev)
              for k in ("rows_local", "cols_local", "vals", "tile_rb",
                        "tile_cb", "tile_init")}
    cnt = fields.get("tile_cnt")
    geom = {k: int(fields[k]) for k in ("n_rows", "n_cols", "block_rows",
                                        "block_cols", "tile_nnz")}
    n_rb = -(-geom["n_rows"] // geom["block_rows"])
    return BBCSR(**arrays, **geom,
                 tile_cnt=None if cnt is None else _tensor(cnt, torch.int32,
                                                           dev),
                 rb_ptr=_rb_ptr(arrays["tile_rb"], n_rb))
