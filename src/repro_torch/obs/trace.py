"""Per-level engine traces (counterpart of ``repro.obs.trace``).

A traced run (``trace=True`` on the engine's runners) returns
``stats['trace']``, a ``(trace_len, 4)`` int32 tensor with one row per
level, columns ``[frontier, was_push, fallback, flush]``: ``frontier`` is
the active count (of the union frontier, for batched lanes) entering the
level, ``was_push`` the direction decision (1 = sparse push / 0 = dense
pull), ``fallback`` the compacted-push capacity overflow flag and ``flush``
the async placement's outbox flush; the last two are 0 on the local
placement, the only one ported.  Levels beyond ``trace_len`` are dropped.
:func:`decode_level_trace` turns the stats into :class:`LevelTrace`
records after the run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

__all__ = ["LevelTrace", "decode_level_trace", "TRACE_COLS"]

#: Column order of the trace rows (engine._core_loop contract).
TRACE_COLS = ("frontier", "was_push", "fallback", "flush")


@dataclasses.dataclass(frozen=True)
class LevelTrace:
    """One decoded engine level."""

    level: int           # 0-based level index
    frontier: int        # active count entering the level
    direction: str       # 'push' | 'pull' ('flush' under async placement)
    fallback: bool       # compacted-push capacity overflow this level
    flush: bool          # outbox flush fired (async placement only)

    def as_dict(self) -> Dict[str, Any]:
        return {"level": self.level, "frontier": self.frontier,
                "direction": self.direction, "fallback": self.fallback,
                "flush": self.flush}


def decode_level_trace(stats: Dict[str, Any]) -> List[LevelTrace]:
    """Decode ``stats['trace']`` (a traced run's stats dict) into records,
    one per recorded level: rows past the run's level count (``pushes +
    pulls``) are unwritten and skipped, and levels past ``trace_len`` were
    never recorded.  The trace is the local placement's (L, 4) layout."""
    if "trace" not in stats:
        raise KeyError("stats has no 'trace' — run the engine with "
                       "trace=True (and return_stats=True)")
    tr = stats["trace"]
    arr = tr.cpu().numpy() if hasattr(tr, "cpu") else np.asarray(tr)
    levels = int(stats["pushes"]) + int(stats["pulls"])
    out: List[LevelTrace] = []
    for lvl in range(min(levels, arr.shape[0])):
        frontier, was_push, fb, flush = (int(v) for v in arr[lvl])
        direction = "flush" if flush else ("push" if was_push else "pull")
        out.append(LevelTrace(level=lvl, frontier=frontier,
                              direction=direction, fallback=bool(fb),
                              flush=bool(flush)))
    return out
