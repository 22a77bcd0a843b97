"""Tuning of the port: sweep, persist, resolve (counterpart of
``repro.tune``).

* :mod:`.space`: the defaults, the sweep grids, the hysteresis rule and the
  BBCSR kernel's shared-memory admissibility;
* :mod:`.resolve`: the lookup of the port's tuned file
  (:data:`TUNED_PATH`, ``tuned.json`` beside this module) with the
  precedence explicit value > entry (backend, nearest scale) > default,
  counting ``tune.autotune_fallback`` on a miss;
* :mod:`.sweep`: the sweep (the port's CUDA kernels timed on a card,
  the reference's deterministic models on the CPU) and the kernel
  measurement lane (:func:`kernel_rows`, :func:`stream_peak_bytes_per_s`);
* ``python -m repro_torch.tune --scale N [--device cpu|cuda]``: writes
  entries into the tuned file.

Importing ``space`` and ``resolve`` loads no torch.  The sweep needs the
core package, which imports this one, so it loads at its first call.
"""
from __future__ import annotations

from . import space
from .resolve import (SCALE_WINDOW, TUNED_PATH, backend_of, clear_cache,
                      load_tuned, lookup, resolve, scale_of)
from .space import DEFAULTS

__all__ = ["space", "DEFAULTS", "resolve", "lookup", "load_tuned",
           "clear_cache", "scale_of", "backend_of", "TUNED_PATH",
           "SCALE_WINDOW", "autotune", "kernel_rows",
           "stream_peak_bytes_per_s"]


def autotune(scale, **kw):
    """Forwards to :func:`repro_torch.tune.sweep.autotune`."""
    from .sweep import autotune as _autotune
    return _autotune(scale, **kw)


def kernel_rows(scale, **kw):
    """Forwards to :func:`repro_torch.tune.sweep.kernel_rows`."""
    from .sweep import kernel_rows as _kernel_rows
    return _kernel_rows(scale, **kw)


def stream_peak_bytes_per_s(**kw):
    """Forwards to :func:`repro_torch.tune.sweep.stream_peak_bytes_per_s`."""
    from .sweep import stream_peak_bytes_per_s as _peak
    return _peak(**kw)
