"""The process mesh of the distributed placement (counterpart of
``repro.launch.mesh.make_cores_mesh``).

The reference is single-controller: one program maps a 1-D device mesh
with ``shard_map``.  The port is multi-controller: one process per shard
(a *rank*), every rank running the same call over ``torch.distributed``.
A :class:`Mesh` is that rank's view of the 1-D mesh: the process group,
its rank and size, the device its shard lives on, the backend and the
one axis name.

Transport, by where the ranks' devices are:

* CPU tensors: gloo;
* one card per rank: NCCL;
* ranks sharing a card (more ranks than cards, as on one H100): gloo over
  CUDA tensors, which stages each collective through host memory.  NCCL
  refuses two ranks on one device.

The shards' data and compute stay on their device in every case; only
the transport differs.  Every collective of the port goes through a
Mesh method (``offload`` routes, reduces and gathers with them), and the
Mesh counts per kind the calls, the bytes it hands to the backend and the
host seconds spent inside the backend's call (for gloo that includes the
staging through host memory): the distributed engine reads the counts
per level.
"""
from __future__ import annotations

import dataclasses
import os
import time
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

__all__ = ["Mesh", "backend_for", "rank_device", "make_cores_mesh", "spawn",
           "KINDS"]

# the collective kinds a Mesh counts
KINDS = ("all_to_all", "all_reduce", "all_gather")

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def backend_for(device, n_ranks: int, n_cards: Optional[int] = None) -> str:
    """The transport for ``n_ranks`` ranks whose shards live on ``device``'s
    type: gloo for the CPU, NCCL when each rank has a card of its own, gloo
    over CUDA tensors when ranks share cards.  ``n_cards`` defaults to the
    cards torch sees."""
    if torch.device(device).type == "cpu":
        return "gloo"
    if n_cards is None:
        n_cards = torch.cuda.device_count()
    if n_cards < 1:
        raise RuntimeError("a CUDA mesh was requested but torch sees no "
                           "card; pass device='cpu' for a CPU mesh")
    return "nccl" if n_cards >= n_ranks else "gloo"


def rank_device(device, rank: int, n_cards: Optional[int] = None
                ) -> torch.device:
    """The device of ``rank``'s shard: the CPU, or card ``rank % n_cards``
    (its own card under NCCL; a shared one under gloo)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if n_cards is None:
        n_cards = torch.cuda.device_count()
    return torch.device("cuda", rank % max(n_cards, 1))


class _AllReduce(torch.autograd.Function):
    """An all-reduce that ``torch.func.vmap`` maps elementwise over lanes:
    the batched tensor is reduced as one (B, ...) collective, which is what
    the valued lanes' programs need (SSSP's per-lane bucket minimum)."""

    @staticmethod
    def forward(x, mesh, op):
        return mesh._all_reduce(x, op)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, x, mesh, op):
        return mesh._all_reduce(x, op), in_dims[0]


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a 1-D process mesh.

    group: the process group (None: the default world group).
    calls / bytes / seconds: per collective kind (:data:`KINDS`), the calls
      made, the bytes handed to the backend (each input buffer once) and
      the host seconds inside the backend's calls.
    """

    group: Any
    rank: int
    size: int
    device: torch.device
    backend: str
    axis_name: str = "cores"
    calls: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    bytes: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    seconds: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0.0))

    def _call(self, kind: str, x: torch.Tensor, fn, *args) -> None:
        """Hand ``x`` to the backend through ``fn(*args)``, counted."""
        self.calls[kind] += 1
        self.bytes[kind] += x.numel() * x.element_size()
        t0 = time.perf_counter()
        fn(*args, group=self.group)
        self.seconds[kind] += time.perf_counter() - t0

    @property
    def collectives(self) -> int:
        return sum(self.calls.values())

    def counts(self) -> dict:
        """A snapshot: {'collectives': total calls, 'calls': {...},
        'bytes': {...}, 'seconds': {...}}."""
        return {"collectives": self.collectives, "calls": dict(self.calls),
                "bytes": dict(self.bytes), "seconds": dict(self.seconds)}

    def reset_counts(self) -> None:
        for k in KINDS:
            self.calls[k] = self.bytes[k] = 0
            self.seconds[k] = 0.0

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Chunk p of ``x`` (leading dim split into ``size`` equal chunks)
        goes to rank p; chunk q of the result came from rank q."""
        if x.shape[0] % self.size:
            raise ValueError(f"all_to_all: leading dim {x.shape[0]} is not "
                             f"divisible by {self.size} ranks")
        x = x.contiguous()
        out = torch.empty_like(x)
        self._call("all_to_all", x, dist.all_to_all_single, out, x)
        return out

    def _all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        y = x.contiguous().clone()
        self._call("all_reduce", y, dist.all_reduce, y, _OPS[op])
        return y

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new tensor holding ``op`` ('sum' | 'min' | 'max') of ``x`` over
        the ranks; under ``torch.func.vmap`` one collective reduces every
        lane."""
        if op not in _OPS:
            raise ValueError(f"unknown reduction {op!r}")
        return _AllReduce.apply(x, self, op)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): row q is rank q's ``x``."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._call("all_gather", x, dist.all_gather, parts, x)
        return torch.stack(parts)

    def gather(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The stacked (size, *x.shape) form on rank 0 (the reference's
        single-controller output), None on the other ranks.  Every rank
        must call it."""
        out = self.all_gather(x)
        return out if self.rank == 0 else None

    def barrier(self) -> None:
        """Wait for every rank (a one-word all-reduce, counted)."""
        self._all_reduce(torch.ones(1, dtype=torch.int32,
                                    device=self.device), "sum")


def make_cores_mesh(device=None, name: str = "cores") -> Mesh:
    """The 1-D mesh over the initialized default process group, this
    rank's shard on ``device``'s type (CUDA unless the caller passes
    ``device='cpu'``; a CUDA request without a card raises)."""
    if not dist.is_initialized():
        raise RuntimeError("make_cores_mesh needs an initialized process "
                           "group (see spawn)")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was requested (the default) but torch"
                           " sees no card; pass device='cpu'")
    rank, size = dist.get_rank(), dist.get_world_size()
    dev = rank_device(dev, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(None, rank, size, dev, dist.get_backend(), name)


def _rank_main(fn, rank, n_ranks, device, backend, init_file, args, conn):
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=n_ranks, rank=rank)
        try:
            mesh = make_cores_mesh(device)
            conn.send((True, fn(mesh, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        conn.send((False, traceback.format_exc()))
        raise
    finally:
        conn.close()


def _reap(procs) -> None:
    """End every rank still running: SIGTERM, then SIGKILL; raise if one
    outlives both."""
    for stop in ("terminate", "kill"):
        live = [p for p in procs if p.is_alive()]
        for p in live:
            getattr(p, stop)()
        for p in live:
            p.join(timeout=10)
    live = [p.pid for p in procs if p.is_alive()]
    if live:
        raise RuntimeError(f"ranks {live} outlived SIGKILL")


def _take(ready, pending: dict, procs, out: dict, failed: dict) -> None:
    """Receive the reports of the ``ready`` pipes (popped from
    ``pending``): a result into ``out``, a traceback or an early exit into
    ``failed``, by rank."""
    for c in ready:
        rank = pending.pop(c)
        try:
            ok, val = c.recv()
        except EOFError:
            procs[rank].join(timeout=10)
            ok, val = False, (f"exited with code {procs[rank].exitcode} "
                              "before it reported\n")
        (out if ok else failed)[rank] = val


def spawn(fn: Callable, n_ranks: int, *, device=None, init_file: str,
          args: tuple = (), timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``n_ranks`` fresh processes (the
    ``spawn`` start method), joined through the file ``init_file`` (which
    must not exist yet: parallel callers each take their own file, so they
    cannot collide as TCP ports can).  ``fn`` must be importable (a
    module-level function) and its results picklable.

    Returns the ranks' results, by rank.  A rank that raises, dies or
    outlives ``timeout`` seconds fails the call: the other ranks are
    terminated (one waiting in a collective would never return) and a
    RuntimeError carries every failed rank's traceback.  The call leaves no process
    behind: every rank is joined (or killed), and the start method's
    resource tracker, when this call started it, is stopped.  The backend
    is :func:`backend_for` the device and rank count."""
    import multiprocessing as mp
    from multiprocessing import connection, resource_tracker
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was requested (the default) but torch"
                           " sees no card; pass device='cpu'")
    if os.path.exists(init_file):
        raise ValueError(f"init file {init_file} exists: each group needs "
                         "a fresh one")
    backend = backend_for(dev, n_ranks)
    ctx = mp.get_context("spawn")
    tracker = resource_tracker._resource_tracker
    own_tracker = tracker._fd is None
    # one pipe per rank, no queue: a queue's semaphores would outlive the
    # call in the resource tracker
    pipes = [ctx.Pipe(duplex=False) for _ in range(n_ranks)]
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n_ranks, str(dev), backend, init_file,
                               args, pipes[r][1]))
             for r in range(n_ranks)]
    out, deadline = {}, time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        for _, w in pipes:
            w.close()
        pending = {pipes[r][0]: r for r in range(n_ranks)}
        failed = {}
        while pending and not failed:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"the ranks did not finish within "
                                   f"{timeout} s")
            _take(connection.wait(list(pending), timeout=left), pending,
                  procs, out, failed)
        if failed:
            # one rank's failure breaks its peers' collectives: take what
            # the others report within a grace second, to name every
            # failed rank (a peer still waiting in a collective never does)
            grace = time.monotonic() + 1.0
            while pending and time.monotonic() < grace:
                _take(connection.wait(list(pending),
                                      timeout=grace - time.monotonic()),
                      pending, procs, out, failed)
            raise RuntimeError("".join(f"rank {r} failed:\n{failed[r]}"
                                       for r in sorted(failed)))
        for p in procs:
            p.join(timeout=60)
    finally:
        try:
            _reap(procs)
        finally:
            for r, _ in pipes:
                r.close()
            if own_tracker:
                tracker._stop()
            if os.path.exists(init_file):
                os.unlink(init_file)
    return [out[r] for r in range(n_ranks)]
