"""Chrome/Perfetto ``trace_event`` export, structural validation, summary
(counterpart of ``repro.obs.export``, the same code).

The export format is the Trace Event JSON object form
(``{"traceEvents": [...]}``) with complete ("X") events only: every event
carries ``pid``/``tid``/``ts``/``dur``/``name`` (µs timestamps), so the file
loads in ``chrome://tracing`` and Perfetto's legacy importer without
metadata events.  Spans map one-to-one; per-level engine traces have no
wall-clock of their own (they were recorded on device), so each traced run
is laid out on its own synthetic tid with the run's engine-span window
subdivided evenly across levels — the *ordering and relative widths* are
synthetic, the per-level args (frontier size, direction, fallback/flush
flags) are the measured payload.

:func:`validate_chrome_trace` is the structural gate the bench and tests
use: field presence plus the per-tid no-partial-overlap rule (spans on one
tid must nest or be disjoint — the property that makes a flame graph
renderable).  Stdlib-only: the summarize CLI (``python -m
repro_torch.obs``) needs neither torch nor a card.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional

from .spans import Span
from .trace import LevelTrace

__all__ = ["build_chrome_trace", "write_chrome_trace",
           "validate_chrome_trace", "summarize", "format_summary"]

#: Synthetic tids for per-run level-trace lanes start here; service spans
#: use small explicit tids (service.py: 1 = client, 2 = service).
LEVEL_TID_BASE = 1000


def build_chrome_trace(spans: Iterable[Span],
                       level_runs: Iterable[Dict[str, Any]] = (),
                       metrics: Optional[Dict[str, Any]] = None,
                       pid: int = 0) -> Dict[str, Any]:
    """Assemble the trace document.

    level_runs: each ``{"name": str, "t0": s, "t1": s,
    "levels": [LevelTrace]}`` — the engine-span window a traced run
    executed in, plus its decoded per-level records.
    metrics: optional registry snapshot, stashed under ``otherData`` (not an
    event stream — counters have no duration).
    """
    events: List[Dict[str, Any]] = []
    for sp in spans:
        events.append({
            "ph": "X", "name": sp.name, "cat": "service",
            "pid": sp.pid if sp.pid else pid, "tid": sp.tid,
            "ts": round(1e6 * sp.ts, 3), "dur": round(1e6 * sp.dur, 3),
            "args": dict(sp.args),
        })
    for i, run in enumerate(level_runs):
        levels: List[LevelTrace] = list(run.get("levels", ()))
        if not levels:
            continue
        t0, t1 = float(run["t0"]), float(run["t1"])
        slot = max(0.0, t1 - t0) / len(levels)
        tid = LEVEL_TID_BASE + i
        for j, lv in enumerate(levels):
            events.append({
                "ph": "X",
                "name": f"{run.get('name', 'engine')}:L{lv.level}"
                        f":{lv.direction}",
                "cat": "level", "pid": pid, "tid": tid,
                "ts": round(1e6 * (t0 + j * slot), 3),
                "dur": round(1e6 * slot, 3),
                "args": lv.as_dict(),
            })
    events.sort(key=lambda e: (e["pid"], e["tid"], e["ts"], -e["dur"]))
    doc: Dict[str, Any] = {"traceEvents": events, "displayTimeUnit": "ms"}
    if metrics is not None:
        doc["otherData"] = {"metrics": metrics}
    return doc


def write_chrome_trace(path: str, spans: Iterable[Span],
                       level_runs: Iterable[Dict[str, Any]] = (),
                       metrics: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    doc = build_chrome_trace(spans, level_runs, metrics)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return doc


def validate_chrome_trace(doc: Dict[str, Any]) -> List[str]:
    """Structural errors ([] = valid): every event is a complete event with
    pid/tid/ts/dur/name, and per (pid, tid) spans nest without partial
    overlap.  Timestamps compare with a 0.5 µs slack — the exporter rounds
    to 1 ns precision, and a child emitted in the same clock read as its
    parent's close may tie exactly."""
    errors: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    lanes: Dict[Any, List[Dict[str, Any]]] = {}
    for i, e in enumerate(events):
        for field in ("pid", "tid", "ts", "dur", "name"):
            if field not in e:
                errors.append(f"event {i} ({e.get('name', '?')}) missing "
                              f"{field!r}")
                break
        else:
            if e.get("ph", "X") == "X":
                lanes.setdefault((e["pid"], e["tid"]), []).append(e)
    eps = 0.5
    for key, lane in lanes.items():
        lane.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[Dict[str, Any]] = []   # open enclosing spans
        for e in lane:
            end = e["ts"] + e["dur"]
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"] - eps:
                stack.pop()
            if stack:
                p = stack[-1]
                if end > p["ts"] + p["dur"] + eps:
                    errors.append(
                        f"tid {key}: {e['name']!r} [{e['ts']:.1f}, {end:.1f}] "
                        f"partially overlaps {p['name']!r} "
                        f"[{p['ts']:.1f}, {p['ts'] + p['dur']:.1f}]")
                    continue
            stack.append(e)
    return errors


def summarize(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Per-phase rollup: for each span name, count / total time / share of
    wall / routed bytes (summed from ``args.route_bytes`` where present).
    Level-lane events (cat == 'level') aggregate per direction instead of
    per name — 40 ``L<k>:push`` rows collapse to one 'level:push' line."""
    events = [e for e in doc.get("traceEvents", ()) if e.get("ph", "X") == "X"]
    if not events:
        return {"wall_ms": 0.0, "phases": {}}
    t_min = min(e["ts"] for e in events)
    t_max = max(e["ts"] + e["dur"] for e in events)
    wall_us = max(t_max - t_min, 1e-9)
    phases: Dict[str, Dict[str, float]] = {}
    for e in events:
        if e.get("cat") == "level":
            name = "level:" + str(e["name"]).rsplit(":", 1)[-1]
        else:
            name = str(e["name"])
        row = phases.setdefault(
            name, {"count": 0, "total_ms": 0.0, "route_bytes": 0})
        row["count"] += 1
        row["total_ms"] += e["dur"] / 1e3
        rb = e.get("args", {}).get("route_bytes")
        if rb is not None:
            row["route_bytes"] += int(rb)
    for row in phases.values():
        row["wall_frac"] = (1e3 * row["total_ms"]) / wall_us
    return {"wall_ms": wall_us / 1e3, "phases": phases}


def format_summary(summary: Dict[str, Any]) -> str:
    """Render the :func:`summarize` rollup as the CLI's fixed-width table."""
    lines = [f"wall time: {summary['wall_ms']:.3f} ms",
             f"{'phase':28s} {'count':>6s} {'total ms':>10s} "
             f"{'% wall':>7s} {'route bytes':>12s}"]
    rows = sorted(summary["phases"].items(),
                  key=lambda kv: -kv[1]["total_ms"])
    for name, row in rows:
        lines.append(f"{name[:28]:28s} {row['count']:6d} "
                     f"{row['total_ms']:10.3f} {100 * row['wall_frac']:6.1f}% "
                     f"{row['route_bytes']:12d}")
    return "\n".join(lines)
