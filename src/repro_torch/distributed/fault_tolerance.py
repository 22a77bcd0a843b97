"""Fault tolerance: the restartable training driver, straggler watch and
elastic re-meshing (counterpart of ``repro.distributed.fault_tolerance``).

:func:`run_training` wraps a step function with
  * periodic async checkpoints (``checkpoint.CheckpointManager``),
  * restore-and-continue across (injected or real) failures,
  * straggler detection: steps slower than ``straggler_factor`` x the
    rolling median are logged with their step index,
  * SIGTERM -> a synchronous final checkpoint (preemption safety).

A step function reads the parameters from the state it is given
(``state.params``), never from a module it closed over: after a restart
the loop hands it the restored state.  A module in the state is restored
in place, so the two are one object anyway.

Over a process mesh every rank runs the loop with its blocks of the state
and the state's placements (``shardings``, as
``configs.common.state_shardings`` gives them): checkpoints are written
whole by rank 0 and restored onto the current mesh, whatever mesh wrote
them, and a failure raised on every rank restarts every rank from the
same checkpoint.  :func:`reshard_state` moves a state between placements
on one process world.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from ..checkpoint.ckpt import CheckpointManager, map_leaves, placements
from ..optim.adamw import TrainState

__all__ = ["FTConfig", "SimulatedFailure", "run_training", "reshard_state"]


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
                 on_metrics: Optional[Callable[[int, dict], None]] = None,
                 shardings: Any = None) -> tuple[Any, dict]:
    """Run to ``max_steps`` with restart-on-failure.  ``state`` is a
    ``TrainState``; ``step_fn(state, batch) -> (state, metrics)``.
    ``shardings``: over a mesh, the state's placements (every rank runs
    the loop).  Returns (state, report)."""
    report = {"restarts": 0, "straggler_events": [], "steps_run": 0}
    durations: list[float] = []

    restored, step0 = ckpt.restore_latest(state, shardings=shardings)
    if restored is not None:
        state = restored
        start = int(step0)
    else:
        start = 0
        ckpt.maybe_save(0, state, force=True, shardings=shardings)

    if ft.install_sigterm:
        def _on_term(signum, frame):
            ckpt.wait()
            ckpt.maybe_save(int(state.step), state, force=True,
                            shardings=shardings)
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
            ckpt.maybe_save(step, state, shardings=shardings)
            if on_metrics is not None:
                on_metrics(step, {k: v.detach().cpu().numpy()
                                  for k, v in metrics.items()})
        except SimulatedFailure:
            restarts += 1
            report["restarts"] = restarts
            if restarts > ft.max_restarts:
                raise
            ckpt.wait()
            restored, step0 = ckpt.restore_latest(state, shardings=shardings)
            if restored is None:
                raise
            state = restored
            step = int(step0)
    ckpt.wait()
    ckpt.maybe_save(step, state, force=True, shardings=shardings)
    ckpt.wait()
    return state, report


def reshard_state(state: Any, shardings: Any, *, old: Any = None) -> Any:
    """The state moved from the placements ``old`` onto ``shardings``
    (each a ``TrainState`` of {name: Placement} dicts, or one dict for a
    tree of parameters; None: whole on every rank): each leaf gathered
    whole from its old placement, then this rank's block of its new one
    taken.  Every rank of the old placements' meshes must call.  A leaf
    that required grad still does.  A module (an LM's parameters) is moved
    in place and keeps its new placements (``placements``)."""
    new_pl, old_pl = placements(state, shardings), placements(state, old)

    @torch.no_grad()
    def move(key, x):
        pl = old_pl.get(key)
        y = x if pl is None else pl.whole(x)
        pl = new_pl.get(key)
        y = y if pl is None else pl.block(y)
        return y.requires_grad_(x.requires_grad) if y is not x else x
    out = map_leaves(state, move)
    params = out.params if isinstance(out, TrainState) else out
    if hasattr(params, "placements"):
        params.placements = (shardings.params if isinstance(
            shardings, TrainState) else shardings)
    return out
