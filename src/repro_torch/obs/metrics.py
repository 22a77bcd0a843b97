"""Metrics registry: counters, gauges, and a log-bucketed histogram
(counterpart of ``repro.obs.metrics``, the same code).

The one place the port's degradation and bookkeeping events land (cache
invalidations, compactions, cost-estimate updates): stdlib only, O(1) per
observation, O(buckets) memory.

Histogram buckets are geometric: bucket ``i`` covers
``[lo * growth**i, lo * growth**(i + 1))``, and a percentile read back from
the histogram is the upper edge of the bucket holding that order statistic,
so it never under-reports.  ``ServiceStats`` serves its latency
percentiles from here; ``tests/test_torch_obs.py`` holds every percentile
bit-equal to the reference's.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "REGISTRY", "get_registry"]


class Counter:
    """Monotonically increasing event count."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) must be >= 0")
        self._value += int(n)

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Log-bucketed histogram over positive values.

    lo: lower edge of bucket 0 — observations below it clamp into bucket 0.
    growth: geometric bucket width; percentile estimates are exact up to one
      factor of ``growth`` (the estimate is the bucket's upper edge, so it
      never *under*-reports a latency percentile).
    n_buckets: observations past the top edge clamp into the last bucket.

    The defaults cover [1 µs, ~1.8 ks) in ~12%-wide buckets — service
    latencies from a cache hit to a pathological cold compile — in 192 ints.
    """

    __slots__ = ("name", "lo", "growth", "_log_growth", "_buckets",
                 "count", "sum")

    def __init__(self, name: str, *, lo: float = 1e-6, growth: float = 1.12,
                 n_buckets: int = 192):
        if not (lo > 0 and growth > 1 and n_buckets > 0):
            raise ValueError(f"histogram {name}: need lo>0, growth>1, "
                             f"n_buckets>0, got {lo}, {growth}, {n_buckets}")
        self.name = name
        self.lo = float(lo)
        self.growth = float(growth)
        self._log_growth = math.log(growth)
        self._buckets = [0] * int(n_buckets)
        self.count = 0
        self.sum = 0.0

    def observe(self, x: float) -> None:
        x = float(x)
        if math.isnan(x):
            return
        self.count += 1
        self.sum += x
        if x <= self.lo:
            i = 0
        else:
            i = min(len(self._buckets) - 1,
                    int(math.log(x / self.lo) / self._log_growth))
        self._buckets[i] += 1

    def bucket_upper(self, i: int) -> float:
        return self.lo * self.growth ** (i + 1)

    def percentile(self, pct: float) -> float:
        """Estimate the pct-th percentile as the upper edge of the bucket
        holding that order statistic (0.0 when empty).  Uses the same
        nearest-rank convention as ``np.percentile(..., method='lower')``
        up to the one-bucket quantization."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(self.count * pct / 100.0))
        seen = 0
        for i, c in enumerate(self._buckets):
            seen += c
            if seen >= rank:
                return self.bucket_upper(i)
        return self.bucket_upper(len(self._buckets) - 1)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class MetricsRegistry:
    """Name -> metric, create-on-first-use.  One process-wide default
    (:data:`REGISTRY`) collects library events (streaming fallbacks, cache
    invalidations, compactions); services and benches may also carry their
    own instance for isolated readouts."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            m = self._counters.get(name)
            if m is None:
                m = self._counters[name] = Counter(name)
            return m

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            m = self._gauges.get(name)
            if m is None:
                m = self._gauges[name] = Gauge(name)
            return m

    def histogram(self, name: str, **kwargs) -> Histogram:
        with self._lock:
            m = self._histograms.get(name)
            if m is None:
                m = self._histograms[name] = Histogram(name, **kwargs)
            return m

    def snapshot(self) -> Dict[str, object]:
        """Flat {name: value} for counters/gauges, {name: dict} for
        histograms — the shape the bench persists and `summarize` renders."""
        with self._lock:
            out: Dict[str, object] = {}
            for n, c in self._counters.items():
                out[n] = c.value
            for n, g in self._gauges.items():
                out[n] = g.value
            for n, h in self._histograms.items():
                out[n] = h.snapshot()
            return out

    def reset(self) -> None:
        """Drop every metric (tests isolate themselves with this)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


#: The process-wide default registry: library code (engine/service/streaming)
#: counts its fallback and degradation events here unconditionally — a
#: counter bump is nanoseconds, so unlike spans there is no off switch.
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
