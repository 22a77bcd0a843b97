"""Host-side spans: the wall-clock half of the observability layer
(counterpart of ``repro.obs.spans``, the same code).

A :class:`Span` is one named, closed time interval on a logical thread
(``tid``) with free-form ``args`` — exactly a Chrome ``trace_event``
complete ("X") event before serialization.  The :class:`SpanRecorder`
keeps them in a bounded deque and enforces the structural contract the
exporter promises downstream (every span closed, per-tid spans either
nest or are disjoint — Perfetto renders overlap as garbage):

* ``span(...)`` (context manager) pushes onto a per-tid stack, so spans
  opened inside another span on the same tid always nest;
* ``record(...)`` admits an interval measured elsewhere (e.g. "time spent
  waiting in the admission queue", whose start predates the recording
  call); its start is clipped to the previous recorded end on that tid so
  retroactive intervals cannot overlap a sibling.

Everything here is host-side stdlib: recording a span never touches a
device tensor.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

__all__ = ["Span", "SpanRecorder"]


@dataclasses.dataclass(frozen=True)
class Span:
    """One closed interval: seconds-based ts/dur, converted to µs on export."""

    name: str
    ts: float            # start, seconds on the recorder's clock
    dur: float           # duration, seconds (>= 0)
    tid: int = 0
    pid: int = 0
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


class SpanRecorder:
    """Bounded span sink with per-tid nesting enforcement.

    clock: injectable monotonic seconds source, so a service driven by a
      fake clock (the deadline tests) records coherent spans.
    capacity: spans retained (oldest dropped) — observability must not be
      the unbounded buffer the latency deque used to be.
    """

    def __init__(self, clock=time.perf_counter, capacity: int = 65536):
        self._clock = clock
        self._spans: "collections.deque[Span]" = \
            collections.deque(maxlen=int(capacity))
        self._stack: Dict[int, List[float]] = {}   # tid -> open-span starts
        self._last_end: Dict[int, float] = {}      # tid -> last closed end

    def now(self) -> float:
        return self._clock()

    @contextmanager
    def span(self, name: str, *, tid: int = 0, **args):
        """Open a span around a code block; ``args`` may be augmented during
        the block via the yielded dict (e.g. a byte count known at exit)."""
        t0 = self._clock()
        self._stack.setdefault(tid, []).append(t0)
        live: Dict[str, Any] = dict(args)
        try:
            yield live
        finally:
            t1 = self._clock()
            self._stack[tid].pop()
            self._emit(Span(name, t0, max(0.0, t1 - t0), tid=tid, args=live))

    def record(self, name: str, t0: float, t1: Optional[float] = None, *,
               tid: int = 0, **args) -> Span:
        """Record an interval measured by the caller.  ``t0`` may lie in the
        past (a queue-wait span emitted at dequeue time); it is clipped
        forward to this tid's previous end so siblings never overlap."""
        if t1 is None:
            t1 = self._clock()
        t0 = min(max(t0, self._last_end.get(tid, t0)), t1)
        sp = Span(name, t0, max(0.0, t1 - t0), tid=tid, args=dict(args))
        self._emit(sp)
        return sp

    def _emit(self, sp: Span) -> None:
        self._spans.append(sp)
        open_starts = self._stack.get(sp.tid)
        if not open_starts:
            # top-level on this tid: later record() calls clip against it
            self._last_end[sp.tid] = max(
                self._last_end.get(sp.tid, 0.0), sp.ts + sp.dur)

    def spans(self) -> List[Span]:
        return list(self._spans)

    def clear(self) -> None:
        self._spans.clear()
        self._last_end.clear()

    def __len__(self) -> int:
        return len(self._spans)
