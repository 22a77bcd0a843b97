"""Observability of the torch port: per-level engine traces (counterpart of
``repro.obs``; the metrics registry, spans and export are not ported yet)."""
from .trace import LevelTrace, TRACE_COLS, decode_level_trace

__all__ = ["LevelTrace", "TRACE_COLS", "decode_level_trace"]
