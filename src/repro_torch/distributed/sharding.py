"""Logical-axis sharding rules (counterpart of
``repro.distributed.sharding``).

Models annotate tensors with *logical* axes; :class:`MeshRules` maps them
onto the axes of a ``launch.mesh.Mesh`` laid out as ('data', 'model') or
('pod', 'data', 'model') (:func:`make_rules`), as the reference maps them
onto a device mesh.  Without a mesh every rule is the identity
(``make_rules(None)``).

The reference is single-controller: a ``NamedSharding`` tells ``jit`` how
a global array is split, and GSPMD moves the data.  The port is
multi-controller: every rank runs the same program on its own block of
each sharded tensor.  A :class:`Placement` is the port's
``NamedSharding``: for each dim, the mesh axes it is split over.  Its two
operations are what ``jax.device_put`` and GSPMD do for the reference:
:meth:`Placement.block` slices a whole tensor to this rank's block, and
:meth:`Placement.whole` all-gathers the blocks back.  A tuple of axes
flattens row-major in grid order, as ``Mesh.over(tuple)`` orders its
ranks (``Mesh.coord``).

:meth:`MeshRules.constrain` stays the identity over a mesh too: in a
multi-controller program each rank already holds its block, and the
models place their tensors themselves (``models/gnn.py``,
``models/recsys.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Union

import torch

Axes = Union[None, str, Sequence[str]]

__all__ = ["MeshRules", "LOGICAL", "Placement", "make_rules"]

# logical axis -> role
LOGICAL = {
    "batch": "data parallel (pod x data)",
    "seq": "sequence parallel (model) — opt-in",
    "heads": "tensor parallel",
    "kv_heads": "tensor parallel (may be smaller than mesh axis)",
    "ff": "tensor parallel",
    "vocab": "tensor parallel",
    "expert": "expert parallel",
    "embed": "FSDP (weights only)",
    "nodes": "graph vertex partition (data x model flattened)",
    "edges": "graph edge partition (data x model flattened)",
    "rows": "embedding-table row partition",
}


def _names(axes: Axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a tensor lies on a mesh: ``entries[k]`` the mesh axes dim k is
    split over (None, a name or a tuple of names, as the reference's
    ``PartitionSpec`` entries), dims past the entries whole.  Placements
    compare by their entries."""

    entries: tuple
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def axes(self) -> tuple:
        """Every mesh axis some dim is split over, in grid order."""
        names = [a for e in self.entries for a in _names(e)]
        if self.mesh is not None:
            names.sort(key=self.mesh.axis_names.index)
        return tuple(names)

    @property
    def replicated(self) -> bool:
        return not self.axes

    def block_shape(self, shape) -> tuple:
        """The shape of this rank's block of a whole tensor of ``shape``."""
        out = list(shape)
        for k, e in enumerate(self.entries):
            if e is not None:
                _, count = self.mesh.coord(e)
                if out[k] % count:
                    raise ValueError(f"dim {k} of {tuple(shape)} does not "
                                     f"split into {count} blocks over {e}")
                out[k] //= count
        return tuple(out)

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``x`` (a copy where it is
        a part, so the whole may be freed; ``x`` itself when replicated)."""
        shape = self.block_shape(x.shape)
        for k, e in enumerate(self.entries):
            if e is not None:
                index, _ = self.mesh.coord(e)
                x = x.narrow(k, index * shape[k], shape[k])
        return x if self.replicated else x.clone()

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block ``x``: one all-gather
        per split dim over its axes' ranks (every rank must call it)."""
        for k, e in enumerate(self.entries):
            if e is not None:
                parts = self.mesh.over(e).all_gather(x)
                x = torch.cat(list(parts.unbind(0)), dim=k)
        return x


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: Any = None      # a launch.mesh.Mesh, or None for one device
    batch: Axes = None
    seq_sp: Axes = None   # sequence-parallel target (None = replicated seq)
    tp: Axes = None
    fsdp: Axes = None
    expert: Axes = None
    flat: Axes = None     # fully-flattened axis set (graph / recsys)

    def spec(self, *logical: Optional[str]) -> tuple:
        """The mesh axes of each logical axis (all None without a mesh)."""
        table = {
            "batch": self.batch, "seq": None, "seq_sp": self.seq_sp,
            "heads": self.tp, "kv_heads": self.tp, "ff": self.tp,
            "vocab": self.tp, "expert": self.expert, "embed": self.fsdp,
            "seq_kv": self.tp, "nodes": self.flat, "edges": self.flat,
            "rows": self.flat, None: None,
        }
        return tuple(table[a] for a in logical)

    def dp_size(self) -> int:
        """Number of data-parallel shards (1 without a mesh)."""
        if self.mesh is None:
            return 1
        return self._axis_size(self.batch)

    def _axis_size(self, axes: Axes) -> int:
        sizes = dict(zip(self.mesh.axis_names, self.mesh.shape))
        n = 1
        for a in _names(axes):
            n *= sizes[a]
        return n

    def constrain(self, x: torch.Tensor,
                  *logical: Optional[str]) -> torch.Tensor:
        """The identity (each rank already holds its block); an unknown
        axis name still raises."""
        self.spec(*logical)
        return x

    def sharding(self, *logical: Optional[str]) -> Optional[Placement]:
        """The placement of these logical axes (None without a mesh)."""
        if self.mesh is None:
            return None
        return Placement(self.spec(*logical), self.mesh)

    def input_sharding(self, shape, *logical: Optional[str]
                       ) -> Optional[Placement]:
        """The placement of a tensor of ``shape``: a dim whose axes' size
        does not divide it stays whole (None without a mesh)."""
        if self.mesh is None:
            return None
        spec = self.spec(*logical)
        spec = spec + (None,) * (len(shape) - len(spec))
        return Placement(tuple(
            axes if axes is None or dim % self._axis_size(axes) == 0
            else None for dim, axes in zip(shape, spec)), self.mesh)


def make_rules(mesh=None, *, seq_parallel: bool = False) -> MeshRules:
    """The rules of a ``launch.mesh.Mesh`` with axes ('data', 'model') or
    ('pod', 'data', 'model'), as the reference builds them; the identity
    rules for ``mesh=None``."""
    if mesh is None:
        return MeshRules(None)
    names = tuple(mesh.axis_names)
    if names not in (("data", "model"), ("pod", "data", "model")):
        raise ValueError(f"sharding rules need a mesh with axes ('data', "
                         f"'model') or ('pod', 'data', 'model'), got "
                         f"{names} (launch.mesh.make_mesh names them)")
    has_pod = "pod" in names
    batch = ("pod", "data") if has_pod else ("data",)
    return MeshRules(
        mesh=mesh,
        batch=batch,
        seq_sp="model" if seq_parallel else None,
        tp="model",
        fsdp=batch,
        expert="model",
        flat=(("pod", "data", "model") if has_pod else ("data", "model")),
    )
