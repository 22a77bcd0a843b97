"""Checkpointing: per-leaf .npy + JSON manifest, atomic, async (counterpart
of ``repro.checkpoint.ckpt``, in its on-disk format).

* atomic    — written to ``<dir>/tmp_<step>`` then renamed to
              ``step_<N>`` (a crashed save never shadows a good one);
* async     — the device-to-host copy is taken synchronously, the disk
              write runs on a thread, so the loop keeps stepping;
* resumable — :func:`latest_step` scans the directory, so a restarted job
              picks up where it died.

The format is the reference's: ``leaf_<i>.npy`` per leaf, and
``manifest.json`` with each leaf's key, shape and logical dtype; bfloat16
is stored as its uint16 bit pattern.  Keys are the reference's pytree
paths joined with "/": a :class:`~repro_torch.optim.adamw.TrainState` is
the tuple (params, m, v, step), so an FM state's keys are ``0/table``,
``0/w0``, ``1/table``, ..., ``3``, and a checkpoint written by either
package restores in the other.  A module's parameters are keyed by their
names with "." read as "/".

The port's train step updates parameters in place, so :func:`save` copies
every leaf to the host before it returns, also when the write is async:
on the CPU ``tensor.numpy()`` would alias the live storage.

Elastic: over a process mesh each rank holds its block of a sharded leaf
(``shardings``: each leaf's ``distributed.sharding.Placement``, as
``configs.common.state_shardings`` gives a ``TrainState``'s).  :func:`save`
gathers every sharded leaf, rank 0 writes the whole arrays, the same
files as one device writes, and every rank waits for the write;
:func:`restore` slices each whole leaf to this rank's block of its
placement, so a checkpoint written on one mesh restores onto any other,
or onto one device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from ..optim.adamw import TrainState

__all__ = ["save", "restore", "latest_step", "CheckpointManager",
           "placements", "map_leaves"]

_SEP = "/"


def _children(node):
    """(key, child) pairs of a container, in the reference's flatten
    order; None for a leaf."""
    if isinstance(node, TrainState):
        return list(enumerate((node.params, node.m, node.v, node.step)))
    if isinstance(node, nn.Module):
        return [(k.replace(".", _SEP), p) for k, p in node.named_parameters()]
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten(tree, prefix=()):
    kids = _children(tree)
    if kids is None:
        return [(_SEP.join(prefix), tree)]
    out = []
    for k, child in kids:
        out.extend(_flatten(child, prefix + (str(k),)))
    return out


def placements(tree, shardings) -> dict:
    """{checkpoint key: Placement} of ``tree``'s leaves: ``shardings`` a
    ``TrainState`` of {parameter name: Placement} dicts (its moments keyed
    as the state's), or one such dict for a tree of parameters; {} for
    None."""
    if shardings is None:
        return {}
    if not isinstance(shardings, TrainState):
        module = isinstance(tree, nn.Module)
        return {(k.replace(".", _SEP) if module else k): v
                for k, v in shardings.items() if v is not None}
    module = isinstance(tree, TrainState) and isinstance(tree.params,
                                                         nn.Module)
    out = {}
    for i, part in enumerate((shardings.params, shardings.m, shardings.v)):
        for name, pl in (part or {}).items():
            if pl is not None:
                key = name.replace(".", _SEP) if i == 0 and module else name
                out[f"{i}{_SEP}{key}"] = pl
    return out


def _mesh_of(places: dict):
    return next((pl.mesh for pl in places.values()), None)


def map_leaves(tree, fn):
    """The tree with each tensor leaf replaced by ``fn(key, leaf)`` (keys
    as :func:`save` writes them); a module is not rebuilt: each of its
    parameters takes the new tensor in place (``.data``)."""
    def build(node, prefix):
        if isinstance(node, TrainState):
            return TrainState(*(build(c, prefix + (str(i),)) for i, c in
                                enumerate((node.params, node.m, node.v,
                                           node.step))))
        if isinstance(node, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, prefix + (str(i),))
                              for i, v in enumerate(node))
        if isinstance(node, nn.Module):
            for k, p in node.named_parameters():
                p.data = fn(_SEP.join(prefix + (k.replace(".", _SEP),)),
                            p.detach())
            return node
        return fn(_SEP.join(prefix), node)
    return build(tree, ())


def _to_host(t) -> tuple:
    """(logical dtype name, numpy array): a host copy, never a view."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
        return str(t.dtype).removeprefix("torch."), t.numpy()
    a = np.array(t)
    return str(a.dtype), a


def save(directory: str, step: int, tree: Any, *, async_: bool = False,
         shardings: Any = None) -> Optional[threading.Thread]:
    """Write the checkpoint of ``step``.  Returns the writer thread when
    async (the host copy is complete when this returns).

    ``shardings`` (see :func:`placements`): the leaves are this rank's
    blocks; every rank must call, each sharded leaf is gathered whole,
    rank 0 writes, and, unless async, every rank waits for the write
    (async: ``CheckpointManager.wait`` waits on every rank)."""
    places = placements(tree, shardings)
    mesh = _mesh_of(places)
    leaves = []
    for k, v in _flatten(tree):
        pl = places.get(k)
        if pl is not None and not pl.replicated:
            v = pl.whole(v.detach())
        leaves.append((k, v))
    if mesh is not None and mesh.rank != 0:
        if not async_:
            mesh.barrier()
        return None
    os.makedirs(directory, exist_ok=True)
    host = [(k,) + _to_host(v) for k, v in leaves]
    manifest = {"step": step,
                "leaves": [{"key": k, "shape": list(a.shape), "dtype": dt}
                           for k, dt, a in host]}

    def _write():
        tmp = os.path.join(directory, f"tmp_{step}")
        final = os.path.join(directory, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for i, (_, _, a) in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), a)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    if mesh is not None:
        mesh.barrier()
    return None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def _from_disk(arr: np.ndarray, logical: str) -> torch.Tensor:
    """A leaf as read from disk, in its logical dtype (bfloat16 from its
    stored bit pattern)."""
    arr = np.require(arr, requirements="C")      # keeps a 0-d shape
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != logical:
        arr = arr.view(np.dtype(logical))      # a stored bit pattern
    return torch.from_numpy(arr)


def restore(directory: str, step: int, target: Any, *, device=None,
            shardings: Any = None) -> Any:
    """The checkpoint of ``step`` in the structure of ``target`` (a tree of
    tensors, real or on the ``meta`` device, or a ``TrainState``): each
    leaf cast to its target's dtype and placed on ``device`` (default: the
    target leaf's device; CUDA for a meta target).  A leaf that requires
    grad in the target requires grad in the result.  A module in the
    target is loaded in place (materialised first if on the meta device)
    and returned as itself.  ``shardings`` (see :func:`placements`): each
    sharded leaf is this rank's block of the whole array, and its target
    may have the block's shape or the whole's.  Raises KeyError for a
    missing key and ValueError for a shape that differs."""
    final = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    keys = {e["key"]: i for i, e in enumerate(manifest["leaves"])}
    places = placements(target, shardings)

    def load(key: str, tgt: torch.Tensor) -> torch.Tensor:
        if key not in keys:
            raise KeyError(f"checkpoint missing leaf {key}")
        entry = manifest["leaves"][keys[key]]
        arr = np.load(os.path.join(final, f"leaf_{keys[key]}.npy"))
        pl = places.get(key)
        shapes = {tuple(arr.shape)}
        if pl is not None:
            shapes.add(pl.block_shape(arr.shape))
        if tuple(tgt.shape) not in shapes:
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                             f"{tuple(tgt.shape)}")
        dev = device
        if dev is None:
            dev = "cuda" if tgt.device.type == "meta" else tgt.device
        out = _from_disk(arr, entry["dtype"])
        if pl is not None:
            out = pl.block(out)
        return out.to(device=dev, dtype=tgt.dtype)

    def build(node, prefix):
        if isinstance(node, TrainState):
            return TrainState(*(build(c, prefix + (str(i),)) for i, c in
                                enumerate((node.params, node.m, node.v,
                                           node.step))))
        if isinstance(node, nn.Module):
            if any(p.device.type == "meta" for p in node.parameters()):
                node.to_empty(device=device or "cuda")
            with torch.no_grad():
                for k, p in node.named_parameters():
                    p.copy_(load(_SEP.join(prefix + (k.replace(".", _SEP),)),
                                 p))
            return node
        if isinstance(node, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, prefix + (str(i),))
                              for i, v in enumerate(node))
        out = load(_SEP.join(prefix), node)
        return out.requires_grad_(True) if node.requires_grad else out

    return build(target, ())


class CheckpointManager:
    """Every-N-steps async checkpointing with bounded retention.  Over a
    mesh (``shardings``) every rank makes the same calls: rank 0 writes
    and prunes, and :meth:`wait` and :meth:`restore_latest` wait for every
    rank, so all of them see the same checkpoints."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        self._mesh = None      # the mesh of a save not yet waited for

    def maybe_save(self, step: int, tree: Any, *, force: bool = False,
                   shardings: Any = None):
        if not force and (self.every <= 0 or step % self.every != 0):
            return
        self.wait()
        self._pending = save(self.directory, step, tree, async_=True,
                             shardings=shardings)
        self._mesh = _mesh_of(placements(tree, shardings))
        if self._mesh is None or self._mesh.rank == 0:
            self._gc(pending_step=step)

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._mesh is not None:
            self._mesh.barrier()
            self._mesh = None

    def _gc(self, pending_step: Optional[int] = None):
        if not os.path.isdir(self.directory):
            return
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        if pending_step is not None and pending_step not in steps:
            steps = sorted(steps + [pending_step])  # count the in-flight save
        doomed = [s for s in steps[: -self.keep] if s != pending_step]
        for s in doomed:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, target, *, device=None, shardings=None):
        """(restored, step) of the newest checkpoint, or (None, None); over
        a mesh (``shardings``) each rank's blocks, once every rank is here.

        Over a mesh rank 0, the rank that writes, reads the directory once
        its own writes are done, and every rank takes its step through one
        all-reduce (the rendezvous the barrier was).  A rank that read the
        directory itself could read it after rank 0, past that rendezvous,
        has started the next save: it would restore where the others start
        afresh, skip the save they make and the barrier that waits for it,
        and pair every later collective with the wrong one."""
        self.wait()
        mesh = _mesh_of(placements(target, shardings))
        step = None if mesh is not None and mesh.rank != 0 else \
            latest_step(self.directory)
        if mesh is not None:
            seen = torch.tensor([-1 if step is None else step],
                                dtype=torch.int32, device=mesh.device)
            step = int(mesh.all_reduce(seen, "max")[0])
            step = None if step < 0 else step
        if step is None:
            return None, None
        return restore(self.directory, step, target, device=device,
                       shardings=shardings), step
