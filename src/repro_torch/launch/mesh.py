"""The process mesh of the distributed placement (counterpart of
``repro.launch.mesh.make_cores_mesh``).

The reference is single-controller: one program maps a device mesh with
``shard_map``.  The port is multi-controller: one process per shard (a
*rank*), every rank running the same call over ``torch.distributed``.  A
:class:`Mesh` is that rank's view of the mesh: the process group, its rank
and size, the device its shard lives on, the backend and the axis names.
A mesh may name several axes over a rank grid (``make_mesh``): each axis,
and each tuple of axes in grid order (flattened row-major, as the
reference's tuple axes are), is a sub-mesh over its own process group
(:meth:`Mesh.over`); the sub-meshes share the mesh's counters.

Transport, by where the ranks' devices are:

* CPU tensors: gloo;
* one card per rank: NCCL;
* ranks sharing a card (more ranks than cards, as on one H100): gloo over
  CUDA tensors, which stages each collective through host memory.  NCCL
  refuses two ranks on one device.

The shards' data and compute stay on their device in every case; only
the transport differs.  Every collective of the port goes through a
Mesh method (``offload`` routes, reduces and gathers with them), and the
Mesh counts per kind the calls, the bytes it hands to the backend, the
host seconds spent inside the backend's call and, for CUDA tensors, the
card seconds between CUDA events recorded on the stream around it.  A
gloo call on CUDA tensors first waits for the card work queued before it,
so its host seconds include that work; the card seconds start when the
stream reaches the call, and so hold the transport alone.  The events
are read without a synchronize: each collective and :meth:`Mesh.counts`
add those the card has passed, :meth:`Mesh.settle` waits for the rest.
The Mesh also counts the routed requests that overflowed a peer's
capacity and were dropped (``core.offload``'s routes add them, on the
device, with no read back).

Every process group the port makes has one timeout (:func:`init_world`,
:func:`spawn`'s ``coll_timeout``; :func:`make_mesh` gives each sub-mesh's
group the world's): a collective that waits longer for its peers raises
on its rank a :class:`CollectiveError` that names the collective (its
kind, its number on the mesh, its bytes and its axis), and ``spawn``
reports it with every rank's stacks.  On a multi-axis grid the flat
sub-mesh over every axis has a group of its own, so the data collectives
routed over it (DGAS exchanges, sums over every axis) never share a gloo
context with the world group's barriers and a checkpoint's waits.

A *dry* mesh (:func:`make_dry_mesh`, :func:`make_production_mesh`) is one
rank's view of a grid with no process group and no peers: its device is
``meta`` and each collective is counted as above and not run, so a step
traced on meta tensors gives that rank's collective inventory
(``launch.dryrun``).  :data:`HW` holds the card the dry run prices it on.
"""
from __future__ import annotations

import dataclasses
import datetime
import faulthandler
import os
import signal
import time
import traceback
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "backend_for", "rank_device", "make_cores_mesh",
           "make_mesh", "make_dry_mesh", "make_production_mesh", "spawn",
           "init_world", "group_timeout", "CollectiveError", "KINDS",
           "HW", "DEFAULT_TIMEOUT_S"]

# the collective kinds a Mesh counts
KINDS = ("all_to_all", "all_reduce", "all_gather")

# seconds a collective waits for its peers, where the caller names no
# other value (torch's own default is 30 minutes)
DEFAULT_TIMEOUT_S = 600.0


class CollectiveError(RuntimeError):
    """A collective that failed or outlived the group's timeout on this
    rank; the message names it."""


def init_world(backend: str, *, init_method: str, world_size: int,
               rank: int, timeout: Optional[float] = None) -> None:
    """``torch.distributed.init_process_group`` with a timeout of
    ``timeout`` seconds (default :data:`DEFAULT_TIMEOUT_S`), which every
    group :func:`make_mesh` makes afterwards shares."""
    t = DEFAULT_TIMEOUT_S if timeout is None else float(timeout)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=t))


def group_timeout(group=None) -> datetime.timedelta:
    """The timeout of a process group (default: the world's), as torch
    holds it for the group's backend."""
    g = dist.group.WORLD if group is None else group
    dev = torch.device("cuda" if dist.get_backend(g) == "nccl" else "cpu")
    return g._get_backend(dev).options._timeout


def _new_group(ranks):
    """A process group over the world ranks ``ranks`` with the world's
    timeout."""
    return dist.new_group(ranks, timeout=group_timeout())


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


def _zeros(v):
    return dataclasses.field(default_factory=lambda: dict.fromkeys(KINDS, v))


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a process mesh.

    group: the process group (None: the default world group).
    axis_name: the name of a 1-D mesh's axis, or a tuple of the names a
      sub-mesh flattens.
    shape / axis_names: the rank grid of a multi-axis mesh (``(size,)`` and
      ``(axis_name,)`` for a 1-D one).
    calls / bytes / seconds / card_seconds: per collective kind
      (:data:`KINDS`), the calls made, the bytes handed to the backend
      (each input buffer once), the host seconds inside the backend's calls
      and the card seconds between events around them (CUDA tensors only).
    dgas: {'dropped': the routed requests this rank sent that overflowed
      a peer's capacity (an int, or a 0-d tensor on the mesh's device)}.
    """

    group: Any
    rank: int
    size: int
    device: torch.device
    backend: str
    axis_name: Any = "cores"
    calls: dict = _zeros(0)
    bytes: dict = _zeros(0)
    seconds: dict = _zeros(0.0)
    card_seconds: dict = _zeros(0.0)
    dgas: dict = dataclasses.field(default_factory=lambda: {"dropped": 0})
    shape: tuple = ()
    axis_names: tuple = ()
    # sub-meshes by axis (a name or a tuple of names); each shares the
    # counters and the pending events of the mesh it came from
    subs: dict = dataclasses.field(default_factory=dict, repr=False)
    pending: list = dataclasses.field(default_factory=list, repr=False)

    def __post_init__(self):
        if not self.shape:
            self.shape, self.axis_names = (self.size,), (self.axis_name,)

    def _call(self, kind: str, x: torch.Tensor, fn, *args,
              what: Optional[str] = None) -> None:
        """Hand ``x`` to the backend through ``fn(*args)``, counted.  A
        failure (a peer that never came within the group's timeout)
        raises :class:`CollectiveError` naming the call (``what``, default
        the kind)."""
        self.calls[kind] += 1
        nbytes = x.numel() * x.element_size()
        self.bytes[kind] += nbytes
        if self.backend == "dry":       # counted, never run
            return
        ev = None
        if x.is_cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        try:
            fn(*args, group=self.group)
        except RuntimeError as e:
            raise CollectiveError(
                f"{what or kind} (the mesh's {kind} call "
                f"{self.calls[kind]}, {nbytes} B, axis {self.axis_name!r} "
                f"on {'the world' if self.group is None else 'its own'} "
                f"group, rank {self.rank} of {self.size}, {self.backend}) "
                f"failed after {time.perf_counter() - t0:.1f} s of a "
                f"{group_timeout(self.group).total_seconds():g} s "
                f"timeout: {e}") from e
        self.seconds[kind] += time.perf_counter() - t0
        if ev is not None:
            ev[1].record()
            self.pending.append((kind, *ev))
            self._drain()

    def _drain(self) -> None:
        """Add the card seconds of the oldest events the card has passed,
        up to the first it has not (the stream passes them in order): the
        backlog stays bounded with no wait."""
        done = 0
        for kind, start, end in self.pending:
            if not end.query():
                break
            self.card_seconds[kind] += start.elapsed_time(end) / 1e3
            done += 1
        del self.pending[:done]

    def settle(self) -> None:
        """Wait for the card to pass every recorded event and add their
        card seconds (a synchronize: call it after a path, not in it)."""
        if self.pending:
            self.pending[-1][2].synchronize()
        self._drain()

    @property
    def collectives(self) -> int:
        return sum(self.calls.values())

    def counts(self) -> dict:
        """A snapshot: {'collectives': total calls, 'calls': {...},
        'bytes': {...}, 'seconds': {...}, 'card_seconds': {...}}; the card
        seconds of the events the card has passed (no wait; the drop count
        is :meth:`dropped`'s, which reads back)."""
        self._drain()
        return {"collectives": self.collectives, "calls": dict(self.calls),
                "bytes": dict(self.bytes), "seconds": dict(self.seconds),
                "card_seconds": dict(self.card_seconds)}

    def reset_counts(self) -> None:
        self.pending.clear()
        for k in KINDS:
            self.calls[k] = self.bytes[k] = 0
            self.seconds[k] = self.card_seconds[k] = 0.0
        self.dgas["dropped"] = 0

    def add_dropped(self, n) -> None:
        """Count ``n`` (an int or a 0-d tensor) dropped requests."""
        self.dgas["dropped"] = self.dgas["dropped"] + n

    def dropped(self) -> int:
        """The requests dropped since the last reset (read back)."""
        return int(self.dgas["dropped"])

    def coord(self, axes) -> tuple:
        """(this rank's block index, the number of blocks) along ``axes``:
        a name or a tuple of names in grid order, flattened row-major as
        :meth:`over` orders its ranks; None is (0, 1)."""
        if axes is None:
            return 0, 1
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        dims = [self.axis_names.index(a) for a in names]
        if dims != sorted(set(dims)):
            raise ValueError(f"axes {names} are not in the grid order of "
                             f"{self.axis_names}")
        at = np.unravel_index(self.rank, self.shape)
        index, count = 0, 1
        for a in dims:
            index = index * self.shape[a] + int(at[a])
            count *= self.shape[a]
        return index, count

    def over(self, axis=None) -> "Mesh":
        """The 1-D mesh a call runs on: ``axis`` None is the first axis
        (the reference's default, the mesh itself when it has one axis), a
        name is that axis's sub-mesh, a tuple of names in grid order the
        flattened sub-mesh over them (all names: the whole world, ranks in
        row-major order)."""
        if axis is None:
            axis = self.axis_names[0]
        if isinstance(axis, list):
            axis = tuple(axis)
        if isinstance(axis, tuple) and len(axis) == 1:
            axis = axis[0]
        if len(self.shape) == 1 and axis in (self.axis_name,
                                             self.axis_names[0]):
            return self
        if axis not in self.subs:
            raise ValueError(f"mesh axes {self.axis_names} have no sub-mesh "
                             f"{axis!r} (a tuple must list axes in grid "
                             f"order)")
        return self.subs[axis]

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
        x = torch.ones(1, dtype=torch.int32, device=self.device)
        self._call("all_reduce", x, dist.all_reduce, x, _OPS["sum"],
                   what="barrier")


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


def _lay_out(mesh: Mesh, shape: tuple, names: tuple, members: list,
             group: Callable) -> None:
    """Lay ``mesh`` out as the rank grid ``shape`` over the world ranks
    ``members`` (row-major: ``mesh.rank`` is this rank's flattened grid
    coordinate, -1 outside the grid) with one name per axis, and give it
    one sub-mesh per axis line and per tuple of axes in grid order.
    ``group(line)`` makes the process group of the world ranks ``line``;
    it is called for every line in the same order on every rank, as
    ``torch.distributed.new_group`` requires.  The flat sub-mesh over
    every axis of a multi-axis grid has a group of its own over all the
    members (the data collectives), apart from the mesh's (the control
    ones).  The sub-meshes share the mesh's counters."""
    import itertools
    inside = mesh.rank >= 0
    mesh.shape, mesh.axis_names = shape, names
    mesh.axis_name = names if len(names) > 1 else names[0]
    coords = np.array(np.unravel_index(np.arange(len(members)), shape)).T
    me = coords[mesh.rank] if inside else None
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(range(len(names)), k):
            key = tuple(names[a] for a in axes)
            key = key[0] if k == 1 else key
            if k == len(names):
                if k > 1:
                    grp = group(list(members))
                    if inside:
                        mesh.subs[key] = dataclasses.replace(
                            mesh, group=grp, axis_name=key, subs={},
                            shape=(mesh.size,),
                            axis_names=("+".join(names),))
                continue
            rest = [a for a in range(len(names)) if a not in axes]
            mine = None
            for fixed in itertools.product(*(range(shape[a]) for a in rest)):
                line = [members[r] for r in range(len(members))
                        if all(coords[r][a] == f
                               for a, f in zip(rest, fixed))]
                grp = group(line)
                if inside and all(me[a] == f for a, f in zip(rest, fixed)):
                    mine = (grp, line)
            if inside:
                grp, line = mine
                mesh.subs[key] = dataclasses.replace(
                    mesh, group=grp, rank=line.index(members[mesh.rank]),
                    size=len(line), axis_name=key, subs={},
                    shape=(len(line),),
                    axis_names=(key if k == 1 else "+".join(key),))


def _grid(shape, axis_names, n_ranks: int) -> tuple:
    shape = tuple(int(s) for s in shape)
    names = tuple(axis_names)
    if len(shape) != len(names) or int(np.prod(shape)) != n_ranks:
        raise ValueError(f"grid {shape} over axes {names} does not hold "
                         f"{n_ranks} ranks")
    return shape, names


def make_mesh(shape, axis_names, device=None, ranks=None):
    """A mesh over the initialized default process group laid out as the
    rank grid ``shape`` (row-major: rank = the flattened coordinate) with
    one name per axis.  Builds one process group per axis line and per
    tuple of axes in grid order (``torch.distributed.new_group``; every
    rank builds every group, as the call requires, each with the world's
    timeout), so :meth:`Mesh.over` gives each axis, or each flattened
    tuple of axes, its own collectives.  The sub-meshes share the mesh's
    counters.  ``ranks``: the world ranks the grid spans, in its order
    (default: all of them); every rank of the world must call, and one
    outside them gets None."""
    world = make_cores_mesh(device)
    members = list(range(world.size)) if ranks is None else \
        [int(r) for r in ranks]
    shape, names = _grid(shape, axis_names, len(members))
    inside = world.rank in members
    mesh = world
    if ranks is not None:
        grp = _new_group(members)
        mesh = dataclasses.replace(
            world, group=grp, size=len(members),
            rank=members.index(world.rank) if inside else -1)
    _lay_out(mesh, shape, names, members, _new_group)
    return mesh if inside else None


def make_dry_mesh(shape, axis_names, rank: int = 0) -> Mesh:
    """Rank ``rank``'s view of the rank grid ``shape``, for a dry run on
    the meta device: its sub-meshes are laid out as :func:`make_mesh`
    lays them, but no process group exists (none is initialised) and a
    collective is counted (calls and bytes per kind) without being run;
    its result is a meta tensor of the right shape."""
    shape, names = _grid(shape, axis_names, int(np.prod(shape)))
    size = int(np.prod(shape))
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} is outside a grid of {size} ranks")
    mesh = Mesh(None, int(rank), size, torch.device("meta"), "dry")
    _lay_out(mesh, shape, names, list(range(size)), lambda line: None)
    return mesh


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> Mesh:
    """Rank ``rank``'s dry view of a production grid: (16, 16) over
    ('data', 'model'), 256 cards, or (2, 16, 16) over ('pod', 'data',
    'model'), 512 (the reference's ``make_production_mesh``)."""
    if multi_pod:
        return make_dry_mesh((2, 16, 16), ("pod", "data", "model"), rank)
    return make_dry_mesh((16, 16), ("data", "model"), rank)


# One NVIDIA H100 80GB HBM3 (SXM5) at its 700 W limit, for the dry run's
# roofline (``launch.dryrun.roofline_terms``) and its fit test
HW = {
    # dense bf16 tensor-core FLOP/s: NVIDIA H100 data sheet, SXM column
    # (1,979 TFLOP/s with 2:4 sparsity, half of it dense)
    "peak_bf16_flops": 989e12,
    # HBM3 bytes/s: the same data sheet, SXM column (3.35 TB/s)
    "hbm_bw": 3.35e12,
    # bytes/s a card sends to another node: one 400 Gb/s NDR InfiniBand
    # port per GPU, as a DGX H100 wires its eight GPUs; every 16-rank axis
    # of the production grids crosses nodes of 8
    "link_bw": 50e9,
    # device memory: torch.cuda.get_device_properties(0).total_memory of
    # the card, as chip_smoke.py's phase 1 prints it (79.18 GiB)
    "hbm_per_chip": 85_017_493_504,

}


# the signal on which a rank writes every thread's stack to its stacks
# file (``spawn`` sends it to the ranks that outlive their timeout)
STACK_SIGNAL = signal.SIGUSR1


def _stacks_file(init_file: str, rank: int) -> str:
    return f"{init_file}.stacks{rank}"


def _rank_main(fn, rank, n_ranks, device, backend, init_file, args, grid,
               coll_timeout, conn):
    stacks = open(_stacks_file(init_file, rank), "w")
    faulthandler.register(STACK_SIGNAL, file=stacks, all_threads=True)
    try:
        if torch.device(device).type == "cpu":
            # one thread: the ranks share the host's cores with each other
            # and with whatever else runs there, and an intra-op pool
            # spins and starves the peer that a collective waits for
            torch.set_num_threads(1)
            torch.set_num_interop_threads(1)
        init_world(backend, init_method=f"file://{init_file}",
                   world_size=n_ranks, rank=rank, timeout=coll_timeout)
        try:
            mesh = make_cores_mesh(device) if grid is None else \
                make_mesh(grid[0], grid[1], device)
            conn.send((True, fn(mesh, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        conn.send((False, traceback.format_exc()))
        raise
    finally:
        conn.close()
        faulthandler.unregister(STACK_SIGNAL)
        stacks.close()


def _dump_stacks(procs, init_file: str) -> str:
    """Ask every live rank for its threads' stacks (:data:`STACK_SIGNAL`)
    and return them, by rank, once each rank's file has stopped growing
    (within a few seconds)."""
    live = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in live:
        try:
            os.kill(procs[r].pid, STACK_SIGNAL)
        except ProcessLookupError:
            pass
    sizes, deadline = None, time.monotonic() + 5.0
    while time.monotonic() < deadline:
        time.sleep(0.2)
        now = [os.path.getsize(_stacks_file(init_file, r))
               if os.path.exists(_stacks_file(init_file, r)) else 0
               for r in live]
        if all(now) and now == sizes:
            break
        sizes = now
    parts = []
    for r in live:
        path = _stacks_file(init_file, r)
        text = open(path).read() if os.path.exists(path) else ""
        parts.append(f"rank {r} stacks:\n" + (text or "(none written)\n"))
    return "".join(parts)


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
          args: tuple = (), timeout: float = 600.0, grid=None,
          coll_timeout: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` on ``n_ranks`` fresh processes (the
    ``spawn`` start method), joined through the file ``init_file`` (which
    must not exist yet: parallel callers each take their own file, so they
    cannot collide as TCP ports can).  ``fn`` must be importable (a
    module-level function) and its results picklable.

    Returns the ranks' results, by rank.  A rank that raises, dies or
    outlives ``timeout`` seconds fails the call: the other ranks are
    terminated (one waiting in a collective would never return) and a
    RuntimeError carries every failed rank's traceback and every live
    rank's stacks (each rank writes them on :data:`STACK_SIGNAL`).  Every
    process group of the ranks has a timeout of ``coll_timeout`` seconds
    (:func:`init_world`), so a collective that a peer never joins fails
    its rank with a :class:`CollectiveError` that names it, well before
    ``timeout`` where ``coll_timeout`` is the smaller.  The call leaves no
    process behind: every rank is joined (or killed), and the start
    method's resource tracker, when this call started it, is stopped.
    The backend is :func:`backend_for` the device and rank count.
    ``grid`` = (shape, axis names) lays the ranks out as :func:`make_mesh`
    does; None gives the 1-D mesh.  A CPU rank runs torch on one
    thread."""
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
                               args, grid, coll_timeout, pipes[r][1]))
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
                                   f"{timeout} s; where each live rank "
                                   f"was:\n"
                                   + _dump_stacks(procs, init_file))
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
                                       for r in sorted(failed))
                               + _dump_stacks(procs, init_file))
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
            for path in [init_file] + [_stacks_file(init_file, r)
                                       for r in range(n_ranks)]:
                if os.path.exists(path):
                    os.unlink(path)
    return [out[r] for r in range(n_ranks)]
