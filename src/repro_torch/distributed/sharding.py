"""Logical-axis sharding rules (counterpart of
``repro.distributed.sharding``), for one device.

Models annotate activations with *logical* axes; :class:`MeshRules` maps
them onto a mesh.  Without a mesh every constraint is the identity, which
is what every model, the serving and training paths and the tests use
(``make_rules(None)``).  Rules over a ``launch.mesh.Mesh`` wait for the
multi-device training slice (ROADMAP §A.9, slice 14):
``make_rules(mesh)`` raises until then.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

Axes = Union[None, str, Sequence[str]]

__all__ = ["MeshRules", "LOGICAL", "make_rules"]

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


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: None
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
        return 1

    def constrain(self, x: torch.Tensor,
                  *logical: Optional[str]) -> torch.Tensor:
        """The sharding constraint: the identity without a mesh."""
        self.spec(*logical)           # an unknown axis name still raises
        return x


def make_rules(mesh=None, *, seq_parallel: bool = False) -> MeshRules:
    """The one-device rules for ``mesh=None``.  A mesh raises: rules over
    ``launch.mesh.Mesh`` wait for slice 14 (ROADMAP §A.9)."""
    if mesh is not None:
        raise NotImplementedError(
            "sharding rules over a mesh are not ported yet (ROADMAP §A.9, "
            "slice 14); pass mesh=None for one device")
    return MeshRules(None)
