"""Tuned-parameter resolution (counterpart of ``repro.tune.resolve``).

``resolve(name, explicit, n=..., device=...)`` is the one funnel every
tunable of the port goes through.  Precedence:

1. an explicit value at the call site (not None) always wins;
2. the entry of the port's tuned file (:data:`TUNED_PATH`) for the backend
   whose scale is nearest the graph's, within :data:`SCALE_WINDOW`
   (a tie goes to the smaller scale);
3. the default of :data:`~repro_torch.tune.space.DEFAULTS`, counted as
   ``tune.autotune_fallback`` in ``repro_torch.obs``'s registry, so that
   untuned runs can be seen.

The backend is the ``device.type`` of the data the call works on
("cpu", "cuda"): a CPU graph on a host with a card resolves the CPU
entries.  A call with no data resolves "cuda", as the entry points build
on the card unless asked otherwise.  Entries are written by
``python -m repro_torch.tune``.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, Optional

from .space import DEFAULTS

__all__ = ["TUNED_PATH", "SCALE_WINDOW", "load_tuned", "lookup", "resolve",
           "scale_of", "backend_of", "clear_cache"]

#: The port's committed tuned file (the reference's TUNED.json is its own).
TUNED_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tuned.json")

#: Max |graph scale - entry scale| (log2 vertices) an entry covers.
SCALE_WINDOW = 3

#: Seconds a parsed document is served before its file's mtime is read
#: again.  The ops wrappers resolve their tiles on every call, and a stat
#: can cost more than a small kernel (a batch-1 decode) on the card
#: host's file system.
RECHECK_S = 1.0

# path -> (monotonic time of the last stat, mtime or None, parsed document
# or None): the file is parsed once per version
_DOC_CACHE: Dict[str, Any] = {}


def clear_cache() -> None:
    """Drop the parsed-document cache (for tests that swap files)."""
    _DOC_CACHE.clear()


def scale_of(n: int) -> int:
    """Graph scale = round(log2 n), the granularity entries are keyed at."""
    return int(round(math.log2(max(int(n), 2))))


def backend_of(device=None) -> str:
    """The backend key of ``device`` (a ``torch.device`` or its string):
    its type; "cuda" when None or ``meta`` (a dry run traces the card's
    calls)."""
    if device is None:
        return "cuda"
    kind = getattr(device, "type", None)
    kind = kind if kind is not None else str(device).split(":")[0]
    return "cuda" if kind == "meta" else kind


def load_tuned(path: Optional[str] = None):
    """The parsed tuned file, or None when it is absent or unreadable (a
    missing file degrades to the counted defaults, it does not raise).
    A file rewritten in place is read again within RECHECK_S seconds."""
    path = path or TUNED_PATH
    now = time.monotonic()
    hit = _DOC_CACHE.get(path)
    if hit is not None and now - hit[0] < RECHECK_S:
        return hit[2]
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = None
    if hit is not None and hit[1] == mtime:
        doc = hit[2]
    elif mtime is None:
        doc = None
    else:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            doc = None
    _DOC_CACHE[path] = (now, mtime, doc)
    return doc


def lookup(backend: str = "cuda", scale: Optional[int] = None, *,
           path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The entry for (backend, scale): same backend, nearest scale within
    SCALE_WINDOW, ties to the smaller scale; None when none matches."""
    doc = load_tuned(path)
    if not doc:
        return None
    best = None
    for entry in doc.get("entries", ()):
        if entry.get("backend") != backend:
            continue
        if scale is None:
            dist = 0
        else:
            dist = abs(int(entry.get("scale", 0)) - int(scale))
            if dist > SCALE_WINDOW:
                continue
        key = (dist, int(entry.get("scale", 0)))
        if best is None or key < best[0]:
            best = (key, entry)
    return best[1] if best else None


def _fallback_counter():
    from ..obs.metrics import get_registry
    return get_registry().counter("tune.autotune_fallback")


def resolve(name: str, explicit: Any = None, *, n: Optional[int] = None,
            scale: Optional[int] = None, device=None,
            path: Optional[str] = None) -> Any:
    """Resolve tunable ``name`` ("<section>.<param>", see space.DEFAULTS).

    explicit: the call site's value, returned untouched when not None.
    n / scale: the graph size keying the lookup (scale wins when both are
    given).  device: where the call's data lies (see :func:`backend_of`).
    path: another tuned file (tests).
    """
    if explicit is not None:
        return explicit
    if name not in DEFAULTS:
        raise KeyError(f"unknown tunable {name!r} (add it to "
                       "repro_torch.tune.space.DEFAULTS)")
    if scale is None and n is not None:
        scale = scale_of(n)
    entry = lookup(backend_of(device), scale, path=path)
    if entry is not None:
        params = entry.get("params", {})
        if name in params:
            return params[name]
    _fallback_counter().inc()
    return DEFAULTS[name]
