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

Streaming mutation: :class:`GraphHandle` is the one graph currency for code
that serves a graph changing under the queries — an immutable (CSR, epoch,
delta log, per-partition mutation stamps) tuple.  ``handle.apply(inserts,
deletes)`` splices a batch of edge updates into the CSR on the CSR's device
(sorted int64 edge keys merged by ``searchsorted``, no global re-sort),
bumps the epoch, stamps the touched partitions and appends to the
:class:`DeltaLog`; once the log outgrows ``compact_threshold`` of the edge
count, the handle compacts back into a clean ``CSR.from_coo`` rebuild.  The
partition arithmetic, the stamps, the log and the :class:`UpdateReport`
arrays are numpy on the host, as in the reference; only the edges stay on
the device.  Epoch and stamp bookkeeping lives here and only here (the
``mutable-handle`` lint rule rejects ``.epoch`` / ``.csr`` / ``.stamps``
assignment anywhere else).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..obs import get_registry

__all__ = ["CSR", "BBCSR", "rmat", "uniform_random_graph", "to_padded_ell",
           "to_bbcsr", "csr_from_numpy", "bbcsr_from_numpy", "resolve_device",
           "contract", "DeltaLog", "UpdateReport", "GraphHandle"]


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

    def weight_prefix(self) -> torch.Tensor:
        """(nnz + 1,) float64 prefix sums of the edge values clamped at 0
        (unit values when there are none); memoized — the weighted
        neighbour draw's inverse CDF."""
        hit = self._memo.get("weight_prefix")
        if hit is None:
            w = torch.ones(self.nnz, dtype=torch.float64, device=self.device) \
                if self.values is None else \
                self.values.to(torch.float64).clamp(min=0)
            hit = self._memo["weight_prefix"] = torch.cat(
                [w.new_zeros(1), torch.cumsum(w, 0)])
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

    def contract(self, labels) -> tuple["CSR", torch.Tensor]:
        """Collapse label groups into supernodes; see :func:`contract`."""
        return contract(self, labels)

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


def contract(csr: CSR, labels) -> tuple[CSR, torch.Tensor]:
    """Collapse communities into a coarsened graph (multi-level Louvain's
    level step), on the CSR's device.

    ``labels`` is any (n_rows,) int assignment.  The labels are renumbered
    to dense coarse vertex ids with :func:`offload.compact_labels`, every
    edge (u, v, w) becomes (label[u], label[v], w), and parallel coarse
    edges are merged by one stable sort of the packed pairs ``label[u] <<
    32 | label[v]`` and an in-order sum of each run (:func:`offload.run_sum`:
    the bits of the reference's CPU segment sum, on the card too).
    Intra-community edges accumulate into self-loops, which keeps
    modularity invariant under contraction.

    Returns (coarse CSR (n_c x n_c, weighted), renumber (n_rows,) int32
    mapping each fine vertex to its coarse vertex id).
    """
    from . import offload

    dev = csr.device
    lab = torch.as_tensor(labels, device=dev).to(torch.int32)
    if lab.shape[0] != csr.n_rows:
        raise ValueError(f"labels must be ({csr.n_rows},), got "
                         f"{tuple(lab.shape)}")
    dense, n_c_dev = offload.compact_labels(lab)
    m = csr.nnz
    if m == 0:
        # the coarse vertex count sizes indptr: read to the host
        # repro-lint: disable=host-sync
        n_c = int(n_c_dev)
        return CSR(torch.zeros(n_c + 1, dtype=torch.int32, device=dev),
                   torch.zeros(0, dtype=torch.int32, device=dev),
                   torch.zeros(0, dtype=torch.float32, device=dev),
                   n_c, n_c), dense
    vals = csr.values if csr.values is not None else torch.ones(
        m, dtype=torch.float32, device=dev)
    rows, cols = csr.index64()
    key, order = torch.sort((dense[rows].long() << 32) | dense[cols].long(),
                            stable=True)
    start, run = offload.run_starts(key)
    # the coarse shapes depend on the labels: the vertex and edge counts
    # are read to the host together, the call's one intended sync
    # repro-lint: disable=host-sync
    n_c, n_runs = torch.stack([n_c_dev.long(), run[-1] + 1]).tolist()
    w = offload.run_sum(run, vals[order], n_runs)
    # each run's key lands in its slot, the rest in the spare last one
    ukey = key.new_empty(n_runs + 1).index_put_(
        (torch.where(start, run, n_runs),), key)[:n_runs]
    urows = ukey >> 32
    indptr = torch.zeros(n_c + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(urows, minlength=n_c), 0)
    return CSR(indptr.to(torch.int32), (ukey & 0xFFFFFFFF).to(torch.int32),
               w, n_c, n_c), dense


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
# Streaming mutation: DeltaLog + epoch-versioned GraphHandle
# ---------------------------------------------------------------------------

def _edge_keys(csr: CSR) -> torch.Tensor:
    """(nnz,) int64 ``row * n_cols + col`` keys on the CSR's device.
    Canonical CSRs (everything a GraphHandle holds) have strictly
    increasing keys: row-major, columns sorted within each row, no
    duplicate (row, col) pairs."""
    rows, cols = csr.index64()
    return rows * csr.n_cols + cols


def _canonical(csr: CSR) -> CSR:
    """Return `csr` if its keys are strictly increasing, else a
    duplicate-summed `from_coo` rebuild (the handle's splice arithmetic
    relies on sorted-unique keys)."""
    key = _edge_keys(csr)
    if key.numel() == 0 or bool((key[1:] > key[:-1]).all()):
        return csr
    return CSR.from_coo(key // csr.n_cols, key % csr.n_cols, csr.values,
                        csr.n_rows, csr.n_cols, sum_duplicates=True,
                        device=csr.device)


def _coerce_edges(edges, *, weighted: bool):
    """Normalize an (rows, cols[, vals]) tuple / None to int64/f32 host
    arrays (the update batch is small; the edges stay on the device)."""
    if edges is None:
        e = np.zeros((0,), np.int64)
        return e, e.copy(), (np.zeros((0,), np.float32) if weighted else None)
    rows, cols = np.asarray(edges[0], np.int64), np.asarray(edges[1], np.int64)
    if rows.shape != cols.shape or rows.ndim != 1:
        raise ValueError(f"edge endpoints must be matching 1-d arrays, got "
                         f"{rows.shape} vs {cols.shape}")
    vals = None
    if weighted:
        vals = (np.asarray(edges[2], np.float32) if len(edges) > 2
                and edges[2] is not None else np.ones(rows.shape, np.float32))
        if vals.shape != rows.shape:
            raise ValueError(f"edge values shape {vals.shape} != {rows.shape}")
    return rows, cols, vals


@dataclasses.dataclass(frozen=True)
class DeltaLog:
    """Pending edge updates since the last compaction, as flat COO arrays
    on the host.

    The log is *bookkeeping*, not the source of truth: every ``apply``
    already splices the batch into the handle's canonical CSR.  The log
    records what changed since the CSR was last rebuilt clean — its size
    drives the compaction trigger, and its endpoint set is what a
    distributed deployment must reship (only the touched partitions)."""

    ins_rows: np.ndarray
    ins_cols: np.ndarray
    ins_vals: Optional[np.ndarray]
    del_rows: np.ndarray
    del_cols: np.ndarray

    @classmethod
    def empty(cls, *, weighted: bool = True) -> "DeltaLog":
        e = np.zeros((0,), np.int64)
        return cls(e, e.copy(), np.zeros((0,), np.float32) if weighted
                   else None, e.copy(), e.copy())

    @property
    def size(self) -> int:
        """Pending update count (inserts + deletes since last compaction)."""
        return int(self.ins_rows.size + self.del_rows.size)

    def extend(self, ins_r, ins_c, ins_v, del_r, del_c) -> "DeltaLog":
        return DeltaLog(
            np.concatenate([self.ins_rows, ins_r]),
            np.concatenate([self.ins_cols, ins_c]),
            None if self.ins_vals is None
            else np.concatenate([self.ins_vals, ins_v]),
            np.concatenate([self.del_rows, del_r]),
            np.concatenate([self.del_cols, del_c]))


@dataclasses.dataclass(frozen=True)
class UpdateReport:
    """What one ``GraphHandle.apply`` batch did — the repair/invalidation
    contract: ``changed_sources`` seeds incremental recompute,
    ``touched_partitions`` scopes cache eviction, ``monotone_safe`` says
    whether label-correcting repair is valid (insert-only, no weight
    increases) or the caller must fall back to full recompute."""

    epoch: int
    n_inserted: int          # new edges spliced in (upserts excluded)
    n_deleted: int           # edges actually removed
    n_upserted: int          # existing edges whose weight was replaced
    changed_sources: np.ndarray     # unique source endpoints of changed edges
    changed_vertices: np.ndarray    # unique endpoints, both sides
    touched_partitions: np.ndarray  # unique partition ids (both endpoints)
    monotone_safe: bool
    compacted: bool

    @property
    def n_changed(self) -> int:
        return self.n_inserted + self.n_deleted + self.n_upserted


@dataclasses.dataclass(frozen=True)
class GraphHandle:
    """Epoch-versioned graph: the one currency for mutable-graph serving.

    Immutable — every mutation returns a NEW handle (so readers holding the
    old one keep a consistent graph+epoch pair):

    * ``apply(inserts, deletes)``: splice one update batch into the CSR —
      deletes drop matched edges, inserts upsert existing (row, col) pairs
      in place and merge genuinely new edges at their sorted positions
      (O(m + d log m) on the CSR's device, no global re-sort).  Bumps the
      epoch, stamps the partitions owning either endpoint of any changed
      edge, and extends the :class:`DeltaLog`.  Batch semantics: deletes
      apply before inserts; duplicate inserts in one batch keep the LAST
      occurrence; inserting an existing edge replaces its weight; deleting
      a missing edge is a no-op; self-loops are ordinary edges.
    * ``replace(csr)``: whole-graph swap — every partition is stamped.
    * ``compact()``: rebuild the CSR clean via ``CSR.from_coo`` and clear
      the log; ``apply`` auto-compacts once the log exceeds
      ``compact_threshold`` × nnz.

    Partitions are contiguous vertex blocks (``ceil(n / n_partitions)`` per
    block).  ``stamps[p]`` is the epoch partition ``p`` last mutated.  The
    arrays the handle and its reports hold are byte-equal to the
    reference's on the same inputs.
    """

    csr: CSR
    epoch: int
    delta: DeltaLog
    stamps: np.ndarray          # (n_partitions,) int64 last-mutated epoch
    n_partitions: int
    compact_threshold: float = 0.25

    @classmethod
    def wrap(cls, csr: CSR, *, n_partitions: int = 8,
             compact_threshold: float = 0.25) -> "GraphHandle":
        if n_partitions < 1:
            raise ValueError("n_partitions must be >= 1")
        return cls(_canonical(csr), 0,
                   DeltaLog.empty(weighted=csr.values is not None),
                   np.zeros((n_partitions,), np.int64), int(n_partitions),
                   float(compact_threshold))

    @property
    def per_partition(self) -> int:
        return -(-self.csr.n_rows // self.n_partitions)

    def partition_of(self, vertices) -> np.ndarray:
        """Owning partition of each vertex (block rule)."""
        return np.asarray(vertices, np.int64) // self.per_partition

    def partition_edge_counts(self) -> np.ndarray:
        """(n_partitions,) edges whose SOURCE row each partition owns —
        what a block-sharded deployment stores (and must reship) per
        partition.  Reads n_partitions + 1 entries of indptr."""
        bounds = np.minimum(np.arange(self.n_partitions + 1)
                            * self.per_partition, self.csr.n_rows)
        indptr = self.csr.indptr
        at = indptr[torch.as_tensor(bounds, device=indptr.device)]
        return np.diff(at.cpu().numpy().astype(np.int64))

    # -- mutation ----------------------------------------------------------

    def apply(self, inserts=None, deletes=None) -> tuple["GraphHandle",
                                                         UpdateReport]:
        """Apply one update batch; returns (new handle, report).

        inserts: (rows, cols) or (rows, cols, vals) arrays; vals default 1.0
          on weighted graphs and are ignored on unweighted (values=None)
          graphs.
        deletes: (rows, cols) arrays.
        """
        weighted = self.csr.values is not None
        ins_r, ins_c, ins_v = _coerce_edges(inserts, weighted=weighted)
        del_r, del_c, _ = _coerce_edges(deletes, weighted=False)
        n, ncol = self.csr.n_rows, self.csr.n_cols
        for name, (r, c) in (("insert", (ins_r, ins_c)),
                             ("delete", (del_r, del_c))):
            if r.size and not ((0 <= r).all() and (r < n).all()
                               and (0 <= c).all() and (c < ncol).all()):
                raise ValueError(f"{name} endpoints outside [0, {n}) x "
                                 f"[0, {ncol})")

        csr, stats = _splice_updates(self.csr, ins_r, ins_c, ins_v,
                                     del_r, del_c)
        n_ins, n_del, n_ups, weight_grew = stats
        epoch = self.epoch + 1

        ch_src = np.unique(np.concatenate([ins_r, del_r]))
        ch_all = np.unique(np.concatenate([ins_r, ins_c, del_r, del_c]))
        touched = np.unique(self.partition_of(ch_all)) if ch_all.size \
            else np.zeros((0,), np.int64)
        stamps = self.stamps.copy()
        stamps[touched] = epoch

        delta = self.delta.extend(ins_r, ins_c, ins_v, del_r, del_c)
        compacted = delta.size > self.compact_threshold * max(1, csr.nnz)
        if compacted:
            csr = _canonical(CSR.from_coo(
                *_coo_of(csr), csr.n_rows, csr.n_cols, device=csr.device))
            delta = DeltaLog.empty(weighted=weighted)
            get_registry().counter("graph.compactions").inc()
        handle = GraphHandle(csr, epoch, delta, stamps, self.n_partitions,
                             self.compact_threshold)
        report = UpdateReport(
            epoch=epoch, n_inserted=n_ins, n_deleted=n_del, n_upserted=n_ups,
            changed_sources=ch_src, changed_vertices=ch_all,
            touched_partitions=touched,
            monotone_safe=(n_del == 0 and not weight_grew),
            compacted=compacted)
        return handle, report

    def replace(self, csr: CSR) -> "GraphHandle":
        """Whole-graph swap: epoch bumps, every partition is stamped."""
        epoch = self.epoch + 1
        csr = _canonical(csr)
        n_p = self.n_partitions
        return GraphHandle(csr, epoch,
                           DeltaLog.empty(weighted=csr.values is not None),
                           np.full((n_p,), epoch, np.int64), n_p,
                           self.compact_threshold)

    def compact(self) -> "GraphHandle":
        """Explicit compaction: clean ``from_coo`` rebuild + empty log.
        Bit-identical arrays (the splice already keeps the CSR
        canonical)."""
        csr = CSR.from_coo(*_coo_of(self.csr), self.csr.n_rows,
                           self.csr.n_cols, device=self.csr.device)
        return GraphHandle(csr, self.epoch,
                           DeltaLog.empty(weighted=csr.values is not None),
                           self.stamps.copy(), self.n_partitions,
                           self.compact_threshold)


def _coo_of(csr: CSR):
    rows, cols = csr.index64()
    return rows, cols, csr.values


def _find(key: torch.Tensor, q: torch.Tensor):
    """Where each of the sorted-unique keys `q` sits in the sorted-unique
    `key`: (insertion position, found)."""
    pos = torch.searchsorted(key, q)
    if key.numel() == 0:
        return pos, torch.zeros_like(q, dtype=torch.bool)
    found = (pos < key.numel()) & (key[pos.clamp(max=key.numel() - 1)] == q)
    return pos, found


def _splice_updates(csr: CSR, ins_r, ins_c, ins_v, del_r, del_c):
    """Splice one update batch into a canonical CSR on its device.

    Returns (new CSR, (n_inserted, n_deleted, n_upserted, weight_grew)).
    The batch's keys are sorted and de-duplicated on the host (it is small),
    then found in the CSR's sorted int64 edge keys by ``searchsorted``:
    deletes drop their hits, upserts overwrite in place, and new edges are
    merged at their insertion positions.  The result is bit-identical to a
    clean ``CSR.from_coo`` over the effective edge set.
    """
    dev = csr.device
    n_cols = int(csr.n_cols)
    key = _edge_keys(csr)
    vals = csr.values

    n_del = 0
    if del_r.size:
        dkey = torch.as_tensor(np.unique(del_r * n_cols + del_c), device=dev)
        pos, hit = _find(key, dkey)
        keep = torch.ones(key.numel(), dtype=torch.bool, device=dev)
        keep[pos[hit]] = False
        n_del = int(hit.sum())
        key = key[keep]
        if vals is not None:
            vals = vals[keep]

    n_ins = n_ups = 0
    weight_grew = False
    if ins_r.size:
        ikey = ins_r * n_cols + ins_c
        order = np.argsort(ikey, kind="stable")
        ikey = ikey[order]
        last = np.ones(ikey.size, bool)          # duplicate keys: last wins
        last[:-1] = ikey[1:] != ikey[:-1]
        ik = torch.as_tensor(ikey[last], device=dev)
        iv = None if ins_v is None or vals is None else \
            torch.as_tensor(ins_v[order][last], device=dev)
        pos, exists = _find(key, ik)
        n_ups = int(exists.sum())
        n_ins = int(ik.numel()) - n_ups
        if iv is not None and n_ups:
            at, new = pos[exists], iv[exists]
            weight_grew = bool((new > vals[at]).any())
            vals = vals.clone()
            vals[at] = new
        if n_ins:
            fresh = ~exists
            # the j-th new key lands after the old keys before its insertion
            # position and the j new keys before it
            slot = pos[fresh] + torch.arange(n_ins, device=dev)
            is_new = torch.zeros(key.numel() + n_ins, dtype=torch.bool,
                                 device=dev)
            is_new[slot] = True
            merged = torch.empty(is_new.numel(), dtype=key.dtype, device=dev)
            merged[slot] = ik[fresh]
            merged[~is_new] = key
            key = merged
            if vals is not None:
                mv = torch.empty(is_new.numel(), dtype=vals.dtype, device=dev)
                mv[slot] = iv[fresh]
                mv[~is_new] = vals
                vals = mv

    rows = key // n_cols
    cols = key - rows * n_cols
    indptr = torch.zeros(csr.n_rows + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=csr.n_rows), 0)
    out = CSR(indptr.to(torch.int32), cols.to(torch.int32), vals,
              csr.n_rows, csr.n_cols)
    out._memo["index64"] = (rows, cols)
    return out, (n_ins, n_del, n_ups, weight_grew)


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
    nnz                     : real nonzeros, the sum of tile_cnt (derived,
                              a host int: the kernels size their schedule
                              by it without reading the device)
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
    nnz: Optional[int] = None

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
                 tile_cnt=tile_cnt, rb_ptr=rb_ptr.to(torch.int32), nnz=m)


def bbcsr_from_numpy(fields: dict, *, device=None) -> BBCSR:
    """The reference's BBCSR fields (arrays as numpy, geometry as ints) ->
    a port BBCSR on ``device``; ``rb_ptr`` is derived from ``tile_rb`` and
    ``nnz`` from ``tile_cnt``."""
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
                 rb_ptr=_rb_ptr(arrays["tile_rb"], n_rb),
                 nnz=None if cnt is None else int(np.asarray(cnt).sum()))
