"""Graph query service: micro-batched multi-source traversal serving
(counterpart of ``repro.core.service`` on the local placement).

A typed query API, an admission queue that micro-batches compatible queries
into one batched engine pass on the CSR's device, an LRU result cache, and
a stats ledger (queries/sec, batch occupancy, cache hit rate, latency
percentiles, deadline-miss rate, route bytes/query).

Queries and their results
-------------------------

=====================  =============================  =====================
query                  engine pass                    result
=====================  =============================  =====================
:class:`Reachability`  bit-packed MS-BFS lane         bool
:class:`Distance`      batched delta-stepping lane    float (inf = no path)
:class:`PPRTopK`       valued personalized-PR lane    (ids (k,), scores (k,))
:class:`NeighborSample` keyed one-hop sample slots    ids (fanout,)
=====================  =============================  =====================

Micro-batching policy: the admission queue preserves submission order
*within* a kind, and each round picks the next kind **round-robin** over the
kinds with pending queries, so a burst of one kind cannot starve the others.
Queries of the round's kind are collected in submission order until the
batch budget of lanes is full.  Traversal queries on the same source share
a lane (dedup), sample queries occupy ``fanout`` slots.  Batches are padded
to the full budget (padding lanes replay lane 0 and are discarded), as in
the reference.  Each batch's result is read back to the host once, after
the runner; answers are the reference's host types (``bool``, ``float``,
numpy arrays).

Deadline-aware admission: ``submit(q, deadline=s)`` attaches a latency SLO
(seconds from submission).  The micro-batcher then flushes not only on
demand but the moment the oldest admitted deadline's *slack* — deadline
minus now minus the kind's estimated batch cost (an EWMA of measured
executions) — is exhausted, or as soon as a kind's pending lane demand
fills the budget.  ``poll()`` is the client-driven tick between
submissions.  The deadline never changes *what* is computed, so it stays
out of the cache key.

Graph mutation: the service's graph currency is an epoch-versioned
:class:`~repro_torch.core.graph.GraphHandle`.  ``apply_updates(inserts,
deletes)`` splices an edge-update batch through ``GraphHandle.apply`` and
invalidates the cache **partition-scoped**: each cached entry records which
partitions its computation touched (the traversal's reached set, mapped to
block partitions), and an update evicts only the entries whose touched set
intersects the mutated partitions.  An edge change at (u, v) can alter a
traversal's result only if the traversal reached u's partition, so an entry
that never touched it never saw the edge.  The legacy ``update_graph(csr)``
whole-swap survives as a deprecated shim over ``GraphHandle.replace``.

Sampled results are cached too: a repeated NeighborSample query returns the
same draw until it is evicted.  The draw is keyed by (service seed, epoch,
query, slot) through ``engine.fold_in``, not by batch composition, so a
cached and a recomputed answer agree.

The distributed placement (``mesh=``) is not ported: the service refuses a
mesh rather than serve it from the local engine (ROADMAP §A.8).
"""
from __future__ import annotations

import collections
import dataclasses
import glob
import json
import os
import re
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import engine, traffic
from .. import tune as _tune
from .graph import CSR, GraphHandle, UpdateReport
from ..obs import Histogram, Observability, get_registry
from .algorithms.bfs import msbfs
from .algorithms.pagerank import ppr_topk
from .algorithms.sssp import auto_delta, sssp_batched

__all__ = [
    "Reachability", "Distance", "PPRTopK", "NeighborSample",
    "ServiceStats", "GraphService", "load_cost_priors",
]


def load_cost_priors(*, distributed: bool = False, budget: int = 32,
                     bench_dir: Optional[str] = None) -> Dict[str, float]:
    """Per-kind batch-cost priors (seconds) from the newest committed bench
    doc (``BENCH_pr<N>.json``, highest N wins, searched in ``bench_dir`` or
    the working directory), read exactly as the reference reads them.

    Seeding the deadline-slack EWMA from a bench run gives admission a
    steady-state prior from the first submit.  Returns {} when no usable doc
    exists, so construction never fails on a missing file.  The committed
    docs are the reference's CPU runs: they say nothing of the card.
    """
    pat = os.path.join(bench_dir or os.getcwd(), "BENCH_pr*.json")
    best, best_n = None, -1
    for p in glob.glob(pat):
        m = re.match(r"BENCH_pr(\d+)\.json$", os.path.basename(p))
        if m and int(m.group(1)) > best_n:
            best, best_n = p, int(m.group(1))
    if best is None:
        return {}
    try:
        with open(best) as f:
            doc = json.load(f)
        section = doc["service_distributed" if distributed else "service"]
        row = section["budgets"][str(budget)]
        if distributed:
            cost = float(row["latency_p50_ms"]) / 1e3
        else:
            cost = float(budget) / float(row["qps"])
    except (KeyError, TypeError, ValueError, OSError):
        return {}
    if not (cost > 0.0 and np.isfinite(cost)):
        return {}
    # one coarse per-batch prior for every kind — the EWMA refines per kind
    return {k: cost for k in _KIND_ROTATION}


# ---------------------------------------------------------------------------
# Typed queries (frozen => hashable => cache keys)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Reachability:
    """Is `target` reachable from `source`?  Served by an MS-BFS lane."""

    source: int
    target: int


@dataclasses.dataclass(frozen=True)
class Distance:
    """Shortest weighted distance source -> target (inf if unreachable).
    Served by a batched delta-stepping lane (the graph-level `auto_delta`)."""

    source: int
    target: int


@dataclasses.dataclass(frozen=True)
class PPRTopK:
    """Top-k personalized-PageRank neighborhood of `source`.  k may vary per
    query up to the service's ``ppr_k_max``; every batch computes
    ``ppr_k_max`` candidates and slices each query's k."""

    source: int
    k: int = 8


@dataclasses.dataclass(frozen=True)
class NeighborSample:
    """`fanout` independent one-hop neighbor draws from `vertex` (uniform
    over out-edges; sinks return the vertex itself).  `seed` salts the draw
    so distinct queries on one vertex stay independent."""

    vertex: int
    fanout: int = 1
    seed: int = 0


_KIND = {Reachability: "reach", Distance: "dist", PPRTopK: "ppr",
         NeighborSample: "sample"}
# fixed rotation for the round-robin batch-kind selection
_KIND_ROTATION = ("reach", "dist", "ppr", "sample")


# ---------------------------------------------------------------------------
# Stats ledger
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServiceStats:
    """Counters over a service's lifetime (or since `reset_stats`).

    route_bytes is the *model* of what a distributed deployment of
    ``n_model_shards`` shards would move: per batched push level one
    compacted exchange at the derived capacity whose items carry all B
    lanes (`traffic.batched_payload_bytes`), per dense level a
    full-partition gather of the lane payloads, priced from the level trace
    the local run reports.

    Latency is recorded per query (submit -> result stored), and every query
    submitted with a deadline counts toward ``deadline_miss_rate`` — a miss
    is a result that lands after its absolute deadline.
    """

    budget: int
    n_model_shards: int = 8
    queries: int = 0
    cache_hits: int = 0
    batches: int = 0
    lanes_used: int = 0
    busy_s: float = 0.0
    route_bytes: int = 0
    push_levels: int = 0
    pull_levels: int = 0
    deadline_queries: int = 0
    deadline_misses: int = 0
    updates: int = 0            # apply_updates batches ingested
    update_edges: int = 0       # edges changed across those batches
    cache_evicted: int = 0      # entries evicted by partition-scoped purges
    # log-bucketed latency sketch: O(buckets) retention no matter how many
    # queries are served, percentiles within one bucket width (12%)
    latency_hist: Histogram = dataclasses.field(
        default_factory=lambda: Histogram("service.latency_s"))

    @property
    def qps(self) -> float:
        return self.queries / self.busy_s if self.busy_s > 0 else 0.0

    @property
    def occupancy(self) -> float:
        """Mean fraction of the lane budget a batch actually fills."""
        return self.lanes_used / (self.batches * self.budget) \
            if self.batches else 0.0

    @property
    def hit_rate(self) -> float:
        return self.cache_hits / self.queries if self.queries else 0.0

    @property
    def route_bytes_per_query(self) -> float:
        return self.route_bytes / self.queries if self.queries else 0.0

    def _latency_pct(self, pct: float) -> float:
        return self.latency_hist.percentile(pct)

    @property
    def latency_p50_ms(self) -> float:
        return 1e3 * self._latency_pct(50)

    @property
    def latency_p95_ms(self) -> float:
        return 1e3 * self._latency_pct(95)

    @property
    def deadline_miss_rate(self) -> float:
        return self.deadline_misses / self.deadline_queries \
            if self.deadline_queries else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "queries": self.queries, "cache_hits": self.cache_hits,
            "batches": self.batches, "lanes_used": self.lanes_used,
            "busy_s": self.busy_s, "route_bytes": self.route_bytes,
            "push_levels": self.push_levels, "pull_levels": self.pull_levels,
            "qps": self.qps, "occupancy": self.occupancy,
            "hit_rate": self.hit_rate,
            "route_bytes_per_query": self.route_bytes_per_query,
            "latency_p50_ms": self.latency_p50_ms,
            "latency_p95_ms": self.latency_p95_ms,
            "deadline_queries": self.deadline_queries,
            "deadline_misses": self.deadline_misses,
            "deadline_miss_rate": self.deadline_miss_rate,
            "updates": self.updates, "update_edges": self.update_edges,
            "cache_evicted": self.cache_evicted,
        }

    def __str__(self) -> str:
        return (f"ServiceStats(queries={self.queries}, qps={self.qps:.1f}, "
                f"occupancy={self.occupancy:.2f}, "
                f"hit_rate={self.hit_rate:.2f}, "
                f"p50={self.latency_p50_ms:.1f}ms, "
                f"p95={self.latency_p95_ms:.1f}ms, "
                f"miss_rate={self.deadline_miss_rate:.3f}, "
                f"route_B/query={self.route_bytes_per_query:.0f}, "
                f"batches={self.batches})")


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------

class GraphService:
    """Serve typed graph queries from one (mutable-by-epoch) graph on its
    CSR's device.

    csr: a port ``CSR`` or ``GraphHandle``; the service runs where the CSR
      lies (CUDA unless the caller built it with ``device="cpu"``).
    batch_budget: lanes per micro-batch — the B the batched engine runs at
      (None = ``service.batch_budget``, repro_torch.tune).
    cache_capacity: LRU entries; 0 disables caching.
    results_capacity: completed-but-unclaimed results kept for
      :meth:`result`; the oldest are dropped beyond this.
    ppr_iters / damping / mode / ppr_k_max: engine knobs shared by every
      query (everything but the source/k/fanout is service-level, so
      same-kind queries always batch — every PPR batch computes
      ``ppr_k_max`` candidates and slices each query's k).
    mesh: the distributed placement is not ported; anything but None raises
      NotImplementedError (ROADMAP §A.8).
    n_model_shards: width of the route-byte model and of the handle's block
      partitions.
    seed: keys the NeighborSample draws (with the epoch, the query and the
      slot).
    clock: injectable monotonic time source (seconds) — deadlines, latency
      percentiles and the EWMA batch-cost estimate all read it.
    deadline_safety: slack margin in seconds — a deadline is considered
      "about to expire" once slack <= this margin.
    placement: 'sync' (default) or 'async'.  The bounded-staleness placement
      relaxes the distributed engine's barriers; without a mesh there is no
      barrier to relax, so it is validated and ignored, as in the
      reference.
    sync_interval: micro-steps per global check under placement='async'
      (taken for the reference's interface; unused without a mesh).
    cost_seed: optional per-kind batch-cost priors in seconds ({kind: s}),
      or 'auto' to read the newest committed bench doc
      (:func:`load_cost_priors`).
    obs: optional :class:`repro_torch.obs.Observability` — attaching one
      turns on host-side span recording (enqueue / flush-wait / engine /
      readback) and per-level engine tracing (each traversal run's decoded
      level trace lands in ``obs.level_runs``).  Counters land in
      ``obs.metrics`` when attached, else the process-wide registry.
    """

    #: EWMA weight for the per-kind batch-cost estimate the deadline slack
    #: subtracts; ~0.3 tracks warmup -> steady-state within a few batches.
    COST_EWMA_ALPHA = 0.3

    def __init__(self, csr, *, batch_budget: Optional[int] = None,
                 cache_capacity: int = 4096, results_capacity: int = 65536,
                 ppr_iters: int = 20, damping: float = 0.85,
                 mode: str = "auto", ppr_k_max: int = 64,
                 mesh=None, n_model_shards: int = 8, seed: int = 0,
                 clock=time.perf_counter, deadline_safety: float = 0.0,
                 placement: str = "sync",
                 sync_interval: Optional[int] = None,
                 cost_seed=None, obs: Optional[Observability] = None):
        if mesh is not None:
            raise NotImplementedError(
                "GraphService(mesh=...): the distributed placement is not "
                "ported yet (ROADMAP §A.8); build the service without a mesh "
                "to serve from the local engine")
        g0 = csr.csr if isinstance(csr, GraphHandle) else csr
        batch_budget = int(_tune.resolve("service.batch_budget",
                                         batch_budget, n=g0.n_rows,
                                         device=g0.device))
        if batch_budget < 1:
            raise ValueError("batch_budget must be >= 1")
        if placement not in ("sync", "async"):
            raise ValueError(f"placement must be 'sync' or 'async', "
                             f"got {placement!r}")
        self.budget = int(batch_budget)
        self.cache_capacity = int(cache_capacity)
        self.results_capacity = int(results_capacity)
        self.ppr_k_max = int(ppr_k_max)
        self.ppr_iters = ppr_iters
        self.damping = damping
        self.mode = mode
        self.seed = seed
        self.placement = placement
        self._clock = clock
        self.obs = obs
        self._metrics = obs.metrics if obs is not None else get_registry()
        self._trace = obs is not None
        self.deadline_safety = float(deadline_safety)
        self.stats = ServiceStats(budget=self.budget,
                                  n_model_shards=n_model_shards)
        self._cache: "collections.OrderedDict[Any, Any]" = \
            collections.OrderedDict()
        # (ticket, query, absolute deadline or None, submit time)
        self._queue: "collections.deque[Tuple[int, Any, Optional[float], float]]" = \
            collections.deque()
        self._results: "collections.OrderedDict[int, Any]" = \
            collections.OrderedDict()
        self._next_ticket = 0
        self._rr = 0                      # round-robin rotation cursor
        self._n_deadlines = 0             # queued entries carrying a deadline
        self._cost_ewma: Dict[str, float] = {}
        if cost_seed == "auto":
            cost_seed = load_cost_priors(budget=self.budget)
        self._cost_ewma.update({k: float(v)
                                for k, v in (cost_seed or {}).items()})
        handle = csr if isinstance(csr, GraphHandle) else \
            GraphHandle.wrap(csr, n_partitions=n_model_shards)
        self._set_graph(handle)

    # -- graph epoch (GraphHandle is the currency; see graph.py) -----------

    @property
    def epoch(self) -> int:
        """The served graph's epoch — read-only handle bookkeeping."""
        return self.handle.epoch

    @property
    def csr(self) -> CSR:
        """The served graph's CSR (the handle's current effective graph)."""
        return self.handle.csr

    @property
    def device(self) -> torch.device:
        return self.handle.csr.device

    def _set_graph(self, handle: GraphHandle) -> None:
        self.handle = handle
        csr = handle.csr
        self.delta = auto_delta(csr)
        self._ppr_k = min(self.ppr_k_max, csr.n_rows)
        m_per = -(-csr.nnz // self.stats.n_model_shards)
        self._edge_cap = engine.frontier_edge_capacity(
            m_per, _tune.resolve("engine.switch_frac", n=csr.n_rows,
                                 device=csr.device),
            n=csr.n_rows, device=csr.device)
        self._m_per_shard = m_per

    def apply_updates(self, inserts=None, deletes=None) -> UpdateReport:
        """Ingest one edge-update batch.

        inserts: (rows, cols) or (rows, cols, vals); deletes: (rows, cols)
        — ``GraphHandle.apply`` semantics (deletes first, duplicate inserts
        last-wins, upserts replace weights).  Bumps the epoch and
        invalidates the cache partition-scoped: entries whose recorded
        touched-partition set is disjoint from the mutation survive.
        Pending queries were admitted against the old graph, so they flush
        against it first.  Returns the
        :class:`~repro_torch.core.graph.UpdateReport`.
        """
        if self._queue:
            self.flush()
        handle, report = self.handle.apply(inserts, deletes)
        self._set_graph(handle)
        evicted = self._invalidate_partitions(report.touched_partitions)
        # route-byte model: a deployment reships the touched partitions'
        # edge lists (every partition on compaction), one contract-payload
        # item per surviving edge
        counts = handle.partition_edge_counts()
        self._charge_ingest(int(counts.sum()) if report.compacted
                            else int(counts[report.touched_partitions].sum()))
        st = self.stats
        st.updates += 1
        st.update_edges += report.n_changed
        st.cache_evicted += evicted
        return report

    def update_graph(self, csr: CSR) -> int:
        """Deprecated whole-graph swap — a thin shim over
        ``GraphHandle.replace`` (every partition is stamped, so the
        partition-scoped invalidation evicts everything).  Use
        :meth:`apply_updates` for streaming deltas.  Pending queries were
        admitted against the old graph, so they are flushed against it
        first."""
        warnings.warn(
            "GraphService.update_graph(csr) is deprecated; use "
            "apply_updates(inserts, deletes) for streaming edge deltas, or "
            "rebuild the service from GraphHandle.replace(csr) for a "
            "whole-graph swap", DeprecationWarning, stacklevel=2)
        if self._queue:
            self.flush()
        self._set_graph(self.handle.replace(csr))
        self._invalidate_partitions(range(self.handle.n_partitions))
        self._charge_ingest(self.csr.nnz)
        return self.epoch

    def reset_stats(self) -> None:
        self.stats = ServiceStats(budget=self.budget,
                                  n_model_shards=self.stats.n_model_shards)

    # -- cache -------------------------------------------------------------
    # entries are q -> (value, touched_parts): `touched_parts` is the
    # frozenset of block partitions the computation read (None = all), so
    # apply_updates can evict exactly the entries a mutation could change.

    def _cache_get(self, q) -> Tuple[bool, Any]:
        if q in self._cache:
            self._cache.move_to_end(q)
            return True, self._cache[q][0]
        return False, None

    def _cache_put(self, q, value, parts: Optional[frozenset] = None) -> None:
        if self.cache_capacity <= 0:
            return
        self._cache[q] = (value, parts)
        self._cache.move_to_end(q)
        while len(self._cache) > self.cache_capacity:
            self._cache.popitem(last=False)

    def _invalidate_partitions(self, parts) -> int:
        """Evict entries whose touched-partition set intersects `parts`
        (entries with no recorded set count as touching everything).
        Returns the number evicted."""
        ps = {int(p) for p in np.asarray(list(parts)).reshape(-1)}
        evict = [k for k, (_, ent) in self._cache.items()
                 if ent is None or ent & ps]
        for k in evict:
            del self._cache[k]
        if evict:
            self._metrics.counter("service.cache_invalidations").inc(
                len(evict))
        return len(evict)

    def _charge_ingest(self, n_edges: int) -> None:
        """Price a reshard of `n_edges` surviving edges in the route-byte
        ledger — contract-payload items (src, dst, weight)."""
        ctr = traffic.RouteByteCounter(self.stats.n_model_shards)
        ctr.contract_level(int(n_edges))
        self.stats.route_bytes += ctr.total_bytes

    def _parts_of_mask(self, reached: np.ndarray) -> frozenset:
        """Touched partitions of one lane's (n,) reached mask (host array):
        block partitions are contiguous vertex ranges, so the mask, padded
        to whole blocks, reduces per block in one pass."""
        per = self.handle.per_partition
        pad = np.zeros(self.handle.n_partitions * per, bool)
        pad[: reached.shape[0]] = reached
        hit = pad.reshape(self.handle.n_partitions, per).any(axis=1)
        return frozenset(int(p) for p in np.flatnonzero(hit))

    # -- admission ---------------------------------------------------------

    def submit(self, q, deadline: Optional[float] = None) -> int:
        """Enqueue a query; returns a ticket for :meth:`result`.

        deadline: optional latency SLO in seconds from now.  Deadline-aware
        admission then arms: the service flushes as soon as the oldest
        admitted deadline's slack (deadline - now - the kind's estimated
        batch cost) runs out, or a kind's pending lane demand fills the
        budget — instead of waiting for an explicit :meth:`flush`.
        """
        if type(q) not in _KIND:
            raise TypeError(f"unknown query type {type(q).__name__}")
        if deadline is not None and deadline < 0:
            raise ValueError(f"deadline must be >= 0, got {deadline}")
        if isinstance(q, NeighborSample) and not 0 < q.fanout <= self.budget:
            raise ValueError(f"fanout {q.fanout} outside [1, {self.budget}] "
                             "(one batch slot per draw)")
        n = self.csr.n_rows
        for field in ("source", "target", "vertex"):
            v = getattr(q, field, None)
            if v is not None and not 0 <= v < n:
                raise ValueError(f"{type(q).__name__}.{field}={v} outside "
                                 f"[0, {n})")
        if isinstance(q, PPRTopK) and not 0 < q.k <= self._ppr_k:
            raise ValueError(f"PPRTopK.k={q.k} outside [1, {self._ppr_k}] "
                             "(raise ppr_k_max to serve larger k)")
        t = self._next_ticket
        self._next_ticket += 1
        now = self._clock()
        self._queue.append((t, q, None if deadline is None else now + deadline,
                            now))
        if self.obs is not None:
            # enqueue span ends before any armed flush below fires, so the
            # client lane never swallows a whole batch execution
            self.obs.spans.record("enqueue", now, self._clock(),
                                  tid=Observability.TID_CLIENT,
                                  kind=_KIND[type(q)], ticket=t,
                                  deadline_s=deadline)
        if deadline is not None:
            self._n_deadlines += 1
        if self._deadline_armed() and (self._deadline_due()
                                       or self._some_kind_full()):
            self.flush()
        return t

    def poll(self) -> List[int]:
        """The client-driven admission tick: flush iff some admitted query's
        deadline slack is exhausted (a no-op otherwise).  Returns the
        tickets served, like :meth:`flush`."""
        if self._deadline_armed() and self._deadline_due():
            return self.flush()
        return []

    def _deadline_armed(self) -> bool:
        # O(1): deadline-free streams pay nothing for the admission checks
        # (the counter resets when flush drains the queue)
        return self._n_deadlines > 0

    def _est_cost(self, kind: str) -> float:
        """EWMA estimate of one batch execution of this kind (0 until the
        first measured batch — an unknown cost must not hold a deadline)."""
        return self._cost_ewma.get(kind, 0.0)

    def _deadline_due(self) -> bool:
        """True iff some admitted deadline is about to expire: its slack
        (deadline - now - estimated batch cost) is within the safety
        margin."""
        now = self._clock()
        return any(dl is not None
                   and now >= dl - self._est_cost(_KIND[type(q)])
                   - self.deadline_safety
                   for _, q, dl, _ in self._queue)

    def _some_kind_full(self) -> bool:
        """True iff some kind's head batch is as packed as it can ever get,
        by replaying `_collect`'s exact accounting: cache hits occupy no
        lane, traversal sources dedupe, and the sample batch cuts at the
        first query whose fanout no longer fits."""
        lanes: Dict[str, Any] = {k: set() for k in _KIND_ROTATION}
        slots = 0
        for _, q, _, _ in self._queue:
            if q in self._cache:
                continue            # will be served from cache, takes no lane
            kind = _KIND[type(q)]
            if kind == "sample":
                if slots + q.fanout > self.budget:
                    return True     # _collect would cut the batch here
                slots += q.fanout
                if slots == self.budget:
                    return True
            else:
                lanes[kind].add(q.source)
                if len(lanes[kind]) >= self.budget:
                    return True
        return False

    def result(self, ticket: int):
        if ticket not in self._results:
            if 0 <= ticket < self._next_ticket and \
                    not any(t == ticket for t, *_ in self._queue):
                raise KeyError(f"ticket {ticket} was claimed already or "
                               "evicted (results_capacity bounds unclaimed "
                               "results)")
            raise KeyError(f"ticket {ticket} has no result (flush pending "
                           "queries first)")
        return self._results.pop(ticket)

    def query(self, q, deadline: Optional[float] = None):
        """Submit + flush + return: the synchronous convenience path."""
        t = self.submit(q, deadline=deadline)
        self.flush()
        return self.result(t)

    def flush(self) -> List[int]:
        """Drain the admission queue; returns the processed tickets in
        submission order.  Each round micro-batches one kind — chosen
        round-robin over the kinds with pending queries, FIFO within the
        kind — up to the lane budget."""
        done: List[int] = []
        t0 = self._clock()
        while self._queue:
            kind = self._next_kind()
            batch, lanes = self._collect(kind, done)
            done.extend(t for t, *_ in batch)
            self._execute(kind, batch, lanes)
            if batch:
                self.stats.batches += 1
        self._n_deadlines = 0           # queue drained: nothing armed
        self.stats.busy_s += self._clock() - t0
        return sorted(done)

    def _next_kind(self) -> str:
        """Round-robin across kinds with pending queries: each kind gets a
        batch per rotation."""
        pending = {_KIND[type(q)] for _, q, *_ in self._queue}
        K = len(_KIND_ROTATION)
        for i in range(K):
            kind = _KIND_ROTATION[(self._rr + i) % K]
            if kind in pending:
                self._rr = (_KIND_ROTATION.index(kind) + 1) % K
                return kind
        raise AssertionError("flush loop entered with an empty queue")

    def _collect(self, kind: str, done: List[int]):
        """Pull same-kind queries from the queue (submission order) until the
        lane budget fills.  Returns ([(ticket, query, deadline, t_submit)],
        ordered lane keys) — traversal queries dedupe on source, sample
        queries take fanout slots."""
        batch: List[Tuple] = []
        lanes: List[int] = []
        slots = 0
        keep: List[Tuple] = []
        while self._queue:
            entry = self._queue.popleft()
            t, q, dl, ts = entry
            if _KIND[type(q)] != kind:
                keep.append(entry)
                continue
            hit, val = self._cache_get(q)
            if hit:
                self._store_result(t, val)
                done.append(t)
                self.stats.queries += 1
                self.stats.cache_hits += 1
                self._account_latency(dl, ts)
                continue
            if kind == "sample":
                need = q.fanout
                if slots + need > self.budget and slots > 0:
                    keep.append(entry)
                    break
                slots += min(need, self.budget)
            else:
                src = q.source
                if src not in lanes:
                    if len(lanes) >= self.budget:
                        keep.append(entry)
                        break
                    lanes.append(src)
            batch.append(entry)
        self._queue.extendleft(reversed(keep))
        return batch, lanes

    # -- execution ---------------------------------------------------------

    def _pad(self, xs: List[int]) -> torch.Tensor:
        """The batch's (budget,) lane sources on the device: padding lanes
        replay lane 0."""
        out = np.zeros((self.budget,), np.int64)
        out[: len(xs)] = xs
        if xs:
            out[len(xs):] = xs[0]
        return torch.as_tensor(out, device=self.device)

    def _account_latency(self, dl: Optional[float], ts: float) -> None:
        now = self._clock()
        self.stats.latency_hist.observe(now - ts)
        if dl is not None:
            self.stats.deadline_queries += 1
            if now > dl:
                self.stats.deadline_misses += 1

    def _update_cost(self, kind: str, seconds: float) -> None:
        prev = self._cost_ewma.get(kind)
        a = self.COST_EWMA_ALPHA
        self._cost_ewma[kind] = seconds if prev is None \
            else (1 - a) * prev + a * seconds
        self._metrics.counter("service.cost_ewma_updates").inc()

    def _charge(self, pushes: int, pulls: int, *, packed: bool) -> None:
        """Route-byte model of a traversal batch's level counts (host ints
        from the runner's stats; see ServiceStats).  Push levels move
        routed items (index + validity header + all budget lanes) at the
        compacted capacity; dense pull levels gather the bare lane payload
        for the full edge partition — no routing header.  The local engine
        routes nothing, so it reports no capacity-overflow fallbacks."""
        st = self.stats
        item = traffic.batched_payload_bytes(self.budget, packed=packed)
        lane_bytes = item - (4 + 1)
        ctr = traffic.RouteByteCounter(st.n_model_shards)
        for _ in range(int(pushes)):
            ctr.push_level(self._edge_cap, payload_bytes=item)
        for _ in range(int(pulls)):
            ctr.pull_level(self._m_per_shard * lane_bytes)
        st.route_bytes += ctr.total_bytes
        st.push_levels += int(pushes)
        st.pull_levels += int(pulls)

    def _execute(self, kind: str, batch, lanes: List[int]) -> None:
        if not batch:
            return
        t_exec = self._clock()
        if self.obs is not None:
            # queue wait + collect, measured from the batch's oldest submit;
            # the recorder clips the start forward to the previous round's
            # readback end, so successive rounds tile the service lane
            self.obs.spans.record(
                "flush_wait", min(ts for *_, ts in batch), t_exec,
                tid=Observability.TID_SERVICE, kind=kind,
                batch_size=len(batch))
        if kind == "sample":
            self._execute_sample(batch)
        else:
            self._execute_traversal(kind, batch, lanes)
        self._update_cost(kind, self._clock() - t_exec)
        for _, _, dl, ts in batch:
            self._account_latency(dl, ts)

    def _execute_traversal(self, kind: str, batch, lanes: List[int]) -> None:
        # the engine span opens before the host->device source upload: the
        # staging transfer is engine dispatch work, not queue wait
        t_eng0 = self._clock()
        rb0 = self.stats.route_bytes
        srcs = self._pad(lanes)
        lane_of = {s: i for i, s in enumerate(lanes)}
        lane_parts: Dict[int, frozenset] = {}
        trace = self._trace

        def parts_of(ln: int, reached: np.ndarray) -> frozenset:
            # memoised per lane (dedup'd queries share the computation)
            if ln not in lane_parts:
                lane_parts[ln] = self._parts_of_mask(reached)
            return lane_parts[ln]

        # each runner's result is read back to the host once (`.cpu()`, the
        # device sync point); the stats it returns are host ints already
        if kind == "reach":
            levels, stats = msbfs(self.csr, srcs, mode=self.mode,
                                  return_stats=True, trace=trace)
            levels = levels.cpu().numpy()
            t_eng1 = self._clock()
            for t, q, *_ in batch:
                ln = lane_of[q.source]
                self._finish(t, q, bool(levels[ln, q.target] >= 0),
                             parts=parts_of(ln, levels[ln] >= 0))
            self._charge(stats["pushes"], stats["pulls"], packed=True)
        elif kind == "dist":
            dist, stats = sssp_batched(self.csr, srcs, delta=self.delta,
                                       mode=self.mode, return_stats=True,
                                       trace=trace)
            dist = dist.cpu().numpy()
            t_eng1 = self._clock()
            for t, q, *_ in batch:
                ln = lane_of[q.source]
                self._finish(t, q, float(dist[ln, q.target]),
                             parts=parts_of(ln, np.isfinite(dist[ln])))
            self._charge(stats["pushes"], stats["pulls"], packed=False)
        elif kind == "ppr":
            # every batch computes ppr_k_max candidates and slices per query
            vals, ids, stats = ppr_topk(self.csr, srcs, self._ppr_k,
                                        damping=self.damping,
                                        iters=self.ppr_iters,
                                        return_stats=True, trace=trace)
            vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
            t_eng1 = self._clock()
            for t, q, *_ in batch:
                ln = lane_of[q.source]
                # PPR iterates dense over the whole graph: parts=None means
                # "touched everything", so any mutation evicts it
                self._finish(t, q, (ids[ln, : q.k].copy(),
                                    vals[ln, : q.k].copy()))
            self._charge(stats["pushes"], stats["pulls"], packed=False)
        self.stats.lanes_used += len(lanes)
        self.stats.queries += len(batch)
        if self.obs is not None:
            self._record_batch_spans(kind, batch, lanes, stats,
                                     t_eng0, t_eng1, rb0)

    def _record_batch_spans(self, kind: str, batch, lanes, stats,
                            t_eng0: float, t_eng1: float, rb0: int) -> None:
        """Close one executed batch's engine + readback spans and decode its
        per-level trace into the attached Observability.  The engine span
        ends at the result readback (the device sync point); everything
        after — per-query extraction, partition attribution, ledger
        pricing — is the readback span."""
        obs = self.obs
        slacks = [dl - t_eng0 for _, _, dl, _ in batch if dl is not None]
        obs.spans.record(
            "engine", t_eng0, t_eng1, tid=Observability.TID_SERVICE,
            kind=kind, lanes=len(lanes), budget=self.budget,
            epoch=self.epoch,
            route_bytes=self.stats.route_bytes - rb0,
            deadline_slack_s=min(slacks) if slacks else None)
        obs.spans.record("readback", t_eng1, self._clock(),
                         tid=Observability.TID_SERVICE, kind=kind)
        if "trace" in stats:
            obs.add_level_run(f"{kind}@{self.epoch}", t_eng0, t_eng1, stats)

    def _execute_sample(self, batch) -> None:
        t_eng0 = self._clock()
        rb0 = self.stats.route_bytes
        # per slot: vertex, and the words its draw key folds in after the
        # service seed and the epoch — (vertex, fanout, query seed, slot),
        # each taken mod 2**64 (a query seed may be any int)
        words = np.zeros((self.budget, 4), np.uint64)
        spans: List[Tuple[int, int]] = []
        pos = 0
        for t, q, *_ in batch:
            take = q.fanout
            # _collect's slot accounting and submit's fanout bound guarantee
            # the batch fits; fail loudly (not by truncating-and-caching a
            # wrong-shaped result) if that invariant ever regresses
            assert pos + take <= self.budget, (pos, take, self.budget)
            words[pos: pos + take] = (q.vertex, q.fanout,
                                      q.seed % (1 << 64), 0)
            words[pos: pos + take, 3] = np.arange(take)
            spans.append((pos, take))
            pos += take
        w = torch.as_tensor(words.view(np.int64), device=self.device)
        keys = engine.fold_in(torch.tensor(
            np.uint64(self.seed % (1 << 64)).view(np.int64),
            device=self.device), self.epoch)
        for j in range(words.shape[1]):
            keys = engine.fold_in(keys, w[:, j])
        nbrs = engine.sample_neighbors(self.csr, w[:, 0], keys).cpu().numpy()
        t_eng1 = self._clock()
        for (t, q, *_), (s, take) in zip(batch, spans):
            # a one-hop draw reads only the vertex's own out-edge list,
            # which lives in its source partition
            self._finish(t, q, nbrs[s: s + take].copy(),
                         parts=frozenset(
                             {int(self.handle.partition_of(q.vertex))}))
        ctr = traffic.RouteByteCounter(self.stats.n_model_shards)
        ctr.push_level(self.budget,
                       payload_bytes=traffic.ROUTE_PAYLOAD_BYTES)
        self.stats.route_bytes += ctr.total_bytes
        self.stats.push_levels += 1
        self.stats.lanes_used += pos
        self.stats.queries += len(batch)
        if self.obs is not None:
            # one-hop sampling has no level loop, so no level-trace run —
            # just the engine/readback pair (stats carries no 'trace')
            self._record_batch_spans("sample", batch, list(range(pos)), {},
                                     t_eng0, t_eng1, rb0)

    def _store_result(self, ticket: int, value) -> None:
        self._results[ticket] = value
        while len(self._results) > self.results_capacity:
            self._results.popitem(last=False)  # oldest unclaimed ticket

    def _finish(self, ticket: int, q, value,
                parts: Optional[frozenset] = None) -> None:
        self._store_result(ticket, value)
        self._cache_put(q, value, parts)
