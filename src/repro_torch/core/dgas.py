"""DGAS: the distributed global address space and its ATT (address
translation table), counterpart of ``repro.core.dgas``.

PIUMA exposes one flat address space across all nodes; programmable ATT
rules decide where each application address lives (interleaved, block
partitioned, ...).  Here the physical location is a rank of the process
mesh, so the ATT is the map

    global element id  ->  (owner shard, local offset)

used alike by the partitioner, the offload engines and the distributed
algorithms.  Every rule is deterministic integer arithmetic (the
degree-balanced cuts are numpy on the host), so the port's tables equal
the reference's value for value.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["ATT", "interleave_rule", "block_rule", "custom_boundary_rule",
           "degree_balanced_rule"]


def _ids(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


@dataclasses.dataclass(frozen=True)
class ATT:
    """Address translation table: global id -> (owner, local offset).

    kind: 'interleave' | 'block' | 'boundaries'.
    n_global: size of the global id space.
    n_shards: number of owners (ranks of the mesh).
    boundaries: (n_shards+1,) int32 CPU tensor for 'boundaries' (shard s
      owns [boundaries[s], boundaries[s+1])), a (1,) placeholder otherwise.

    The translations take tensors (or anything ``torch.as_tensor`` takes)
    on any device and return tensors of the ids' dtype on their device.
    """

    kind: str
    n_global: int
    n_shards: int
    boundaries: torch.Tensor
    _memo: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    @property
    def per_shard(self) -> int:
        """Padded local capacity (the most elements any shard owns)."""
        if self.kind in ("interleave", "block") or \
                self.boundaries.shape[0] <= 1:
            return -(-self.n_global // self.n_shards)
        b = self.boundaries.numpy()
        return int(np.max(b[1:] - b[:-1]))

    def _bounds(self, device) -> torch.Tensor:
        """The boundaries as int64 on ``device``, kept per device."""
        key = str(device)
        hit = self._memo.get(key)
        if hit is None:
            hit = self._memo[key] = self.boundaries.to(device, torch.int64)
        return hit

    def owner(self, gid) -> torch.Tensor:
        """Owner shard of each global id."""
        gid = _ids(gid)
        if self.kind == "interleave":
            return gid % self.n_shards
        if self.kind == "block":
            return gid // -(-self.n_global // self.n_shards)
        own = torch.searchsorted(self._bounds(gid.device), gid.long(),
                                 right=True) - 1
        return own.clamp(0, self.n_shards - 1).to(gid.dtype)

    def local(self, gid) -> torch.Tensor:
        """Local offset of each global id within its owner shard."""
        gid = _ids(gid)
        if self.kind == "interleave":
            return gid // self.n_shards
        if self.kind == "block":
            return gid % -(-self.n_global // self.n_shards)
        start = self._bounds(gid.device)[self.owner(gid).long()]
        return (gid.long() - start).to(gid.dtype)

    def to_global(self, shard, local) -> torch.Tensor:
        """Inverse translation: (owner, local) -> global id."""
        shard, local = _ids(shard), _ids(local)
        if self.kind == "interleave":
            return local * self.n_shards + shard
        if self.kind == "block":
            return shard * -(-self.n_global // self.n_shards) + local
        start = self._bounds(local.device)[shard.long()]
        return (start + local.long()).to(local.dtype)

    def flat_slot(self, gid) -> torch.Tensor:
        """Dense outbox address of each global id, owner * per_shard +
        local: the slot a message for ``gid`` takes in the async
        placement's (n_shards * per_shard, ...) deferred-message buffer
        (``offload.buffered_flush``)."""
        return self.owner(gid) * self.per_shard + self.local(gid)

    def shard_slice(self, shard: int) -> tuple[int, int]:
        """(start, count) of the globally contiguous ids ``shard`` owns.
        Only contiguous rules ('block' / 'boundaries') have one."""
        if self.kind == "block":
            per = -(-self.n_global // self.n_shards)
            start = shard * per
            return start, max(0, min(per, self.n_global - start))
        if self.kind == "boundaries":
            b = self.boundaries
            return int(b[shard]), int(b[shard + 1] - b[shard])
        raise ValueError("interleave rule has no contiguous shard slice")

    def resident(self, shard: int, device) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
        """(gid, valid) of ``shard``'s per_shard local slots on ``device``:
        each slot's global id, and whether the slot holds a real vertex
        (padding slots past the shard's span do not)."""
        local = torch.arange(self.per_shard, device=device)
        gid = self.to_global(torch.full_like(local, shard), local)
        return gid, (gid < self.n_global) & (self.owner(gid) == shard)


def _placeholder() -> torch.Tensor:
    return torch.zeros(1, dtype=torch.int32)


def interleave_rule(n_global: int, n_shards: int) -> ATT:
    """PIUMA 'address interleaved' rule: id % n_shards."""
    return ATT("interleave", n_global, n_shards, _placeholder())


def block_rule(n_global: int, n_shards: int) -> ATT:
    """PIUMA 'block partitioned' rule: contiguous equal blocks."""
    return ATT("block", n_global, n_shards, _placeholder())


def custom_boundary_rule(boundaries, n_global: int) -> ATT:
    """Arbitrary contiguous partition given explicit boundaries
    (n_shards+1,)."""
    b = torch.from_numpy(np.array(boundaries, dtype=np.int32))
    return ATT("boundaries", n_global, int(b.shape[0]) - 1, b)


def degree_balanced_rule(indptr, n_shards: int) -> ATT:
    """Contiguous row partition balancing *nonzeros* (the paper's SpMV
    rule: "rows are partitioned across the threads based on the number of
    non-zeros for a balanced execution").  ``indptr`` may be a tensor on
    any device; the cuts are taken on the host with numpy."""
    indptr = indptr.cpu().numpy() if isinstance(indptr, torch.Tensor) \
        else np.asarray(indptr)
    n_rows = indptr.shape[0] - 1
    nnz = int(indptr[-1])
    targets = (np.arange(1, n_shards) * (nnz / n_shards)).astype(np.int64)
    cuts = np.searchsorted(indptr, targets, side="left")
    boundaries = np.concatenate([[0], cuts, [n_rows]]).astype(np.int32)
    boundaries = np.maximum.accumulate(boundaries)  # monotone under ties
    return custom_boundary_rule(boundaries, n_rows)
