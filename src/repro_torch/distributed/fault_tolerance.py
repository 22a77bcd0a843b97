"""Fault tolerance: the restartable training driver and straggler watch
(counterpart of ``repro.distributed.fault_tolerance``, one device).

:func:`run_training` wraps a step function with
  * periodic async checkpoints (``checkpoint.CheckpointManager``),
  * restore-and-continue across (injected or real) failures,
  * straggler detection: steps slower than ``straggler_factor`` x the
    rolling median are logged with their step index,
  * SIGTERM -> a synchronous final checkpoint (preemption safety).

A step function reads the parameters from the state it is given
(``state.params``), never from a module it closed over: after a restart
the loop hands it the restored state.  A module in the state is restored
in place, so the two are one object anyway.  Restoring across meshes
(the reference's ``reshard_state``) waits for rules over a mesh.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from ..checkpoint.ckpt import CheckpointManager

__all__ = ["FTConfig", "SimulatedFailure", "run_training"]


class SimulatedFailure(RuntimeError):
    """Raised by a fail_injector to emulate a node loss."""


@dataclasses.dataclass
class FTConfig:
    ckpt_every: int = 50
    max_restarts: int = 3
    straggler_factor: float = 3.0
    straggler_window: int = 32
    install_sigterm: bool = False


def _sync(state) -> None:
    """Wait for the card's queued work (the reference's
    ``block_until_ready``); nothing on the CPU."""
    dev = state.step.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_training(step_fn: Callable, state: Any, batches: Iterator,
                 ckpt: CheckpointManager, max_steps: int,
                 ft: FTConfig = FTConfig(), *,
                 fail_injector: Optional[Callable[[int], None]] = None,
                 on_metrics: Optional[Callable[[int, dict], None]] = None
                 ) -> tuple[Any, dict]:
    """Run to ``max_steps`` with restart-on-failure.  ``state`` is a
    ``TrainState``; ``step_fn(state, batch) -> (state, metrics)``.  Returns
    (state, report)."""
    report = {"restarts": 0, "straggler_events": [], "steps_run": 0}
    durations: list[float] = []

    restored, step0 = ckpt.restore_latest(state)
    if restored is not None:
        state = restored
        start = int(step0)
    else:
        start = 0
        ckpt.maybe_save(0, state, force=True)

    if ft.install_sigterm:
        def _on_term(signum, frame):
            ckpt.wait()
            ckpt.maybe_save(int(state.step), state, force=True)
            raise SystemExit(143)
        signal.signal(signal.SIGTERM, _on_term)

    step = start
    restarts = 0
    while step < max_steps:
        try:
            batch = next(batches)
            if fail_injector is not None:
                fail_injector(step)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            _sync(state)
            dt = time.perf_counter() - t0
            durations.append(dt)
            if len(durations) > ft.straggler_window:
                durations.pop(0)
            med = float(np.median(durations))
            if len(durations) >= 8 and dt > ft.straggler_factor * med:
                report["straggler_events"].append(
                    {"step": step, "dt": dt, "median": med})
            step += 1
            report["steps_run"] += 1
            ckpt.maybe_save(step, state)
            if on_metrics is not None:
                on_metrics(step, {k: v.detach().cpu().numpy()
                                  for k, v in metrics.items()})
        except SimulatedFailure:
            restarts += 1
            report["restarts"] = restarts
            if restarts > ft.max_restarts:
                raise
            ckpt.wait()
            restored, step0 = ckpt.restore_latest(state)
            if restored is None:
                raise
            state = restored
            step = int(step0)
    ckpt.wait()
    ckpt.maybe_save(step, state, force=True)
    ckpt.wait()
    return state, report
