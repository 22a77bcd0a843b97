"""Observability of the torch port (counterpart of ``repro.obs``).

Three measurement planes, one export:

* **device**: per-level engine traces — ``trace=True`` on the engine runners
  records ``(frontier, direction, fallback, flush)`` per level (see
  :mod:`repro_torch.obs.trace` for the decode contract);
* **host**: spans — :class:`~repro_torch.obs.spans.SpanRecorder` wraps each
  query's life (enqueue → flush-wait → engine → readback) in closed,
  nest-checked intervals;
* **counters**: :mod:`repro_torch.obs.metrics` — the process-wide registry
  the port's degradation and bookkeeping events land in.

:class:`Observability` bundles the three for one consumer (a
``GraphService``) and exports them as one Chrome ``trace_event`` JSON.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, REGISTRY,
                      get_registry)
from .spans import Span, SpanRecorder
from .trace import LevelTrace, TRACE_COLS, decode_level_trace
from .export import (build_chrome_trace, write_chrome_trace,
                     validate_chrome_trace, summarize, format_summary)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "get_registry", "Span", "SpanRecorder", "LevelTrace", "TRACE_COLS",
    "decode_level_trace", "build_chrome_trace", "write_chrome_trace",
    "validate_chrome_trace", "summarize", "format_summary",
    "Observability", "export_chrome_trace",
]


class Observability:
    """One consumer's telemetry bundle: spans + level traces + metrics.

    Attach one to a ``GraphService(obs=...)`` to turn on span recording and
    per-level engine tracing for that service; the metrics registry defaults
    to the process-wide one (counters are always on), but an isolated
    :class:`MetricsRegistry` may be passed for hermetic readouts.
    """

    #: Logical thread ids of the service span schema.
    TID_CLIENT = 1       # enqueue spans (submit-side)
    TID_SERVICE = 2      # batch / flush-wait / engine / readback spans

    def __init__(self, clock=time.perf_counter,
                 metrics: Optional[MetricsRegistry] = None,
                 span_capacity: int = 65536):
        self.spans = SpanRecorder(clock=clock, capacity=span_capacity)
        self.metrics = metrics if metrics is not None else get_registry()
        self.level_runs: List[Dict[str, Any]] = []

    def add_level_run(self, name: str, t0: float, t1: float,
                      stats: Dict[str, Any]) -> List[LevelTrace]:
        """Register one traced engine run: decode its per-level records and
        anchor them to the wall-clock window ``[t0, t1]`` the engine span
        measured (the exporter lays the levels out inside it)."""
        levels = decode_level_trace(stats)
        self.level_runs.append({"name": name, "t0": float(t0),
                                "t1": float(t1), "levels": levels})
        return levels

    def build_trace(self) -> Dict[str, Any]:
        return build_chrome_trace(self.spans.spans(), self.level_runs,
                                  self.metrics.snapshot())

    def export_chrome_trace(self, path: str) -> Dict[str, Any]:
        """Write the Chrome ``trace_event`` JSON; returns the document."""
        doc = self.build_trace()
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return doc

    def summary(self) -> Dict[str, Any]:
        return summarize(self.build_trace())

    def clear(self) -> None:
        self.spans.clear()
        self.level_runs.clear()


def export_chrome_trace(path: str, obs: Observability) -> Dict[str, Any]:
    """Module-level convenience: ``obs.export_chrome_trace(path)``."""
    return obs.export_chrome_trace(path)
