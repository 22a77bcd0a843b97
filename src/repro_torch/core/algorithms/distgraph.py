"""Distributed (DGAS-partitioned) graph representation, counterpart of
``repro.core.algorithms.distgraph``.

On the host: partition CSR rows with a programmable ATT rule (default:
the paper's degree-balanced rule) into *stacked* per-shard COO arrays with
identical padding, built exactly as the reference builds them.  Each rank
then takes its own row onto its device (:meth:`ShardedGraph.shard`).

Vertex data (x vectors, levels, labels, ...) is sharded with its own ATT
rule — the two rules need not agree; all cross-references go through the
offload engines.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..dgas import ATT, degree_balanced_rule
from ..graph import CSR

__all__ = ["ShardedGraph", "GraphShard", "shard_graph", "local_shard",
           "update_shards", "shard_vertex_array", "unshard_vertex_array"]


@dataclasses.dataclass(frozen=True)
class GraphShard:
    """One rank's edge list on its device.  Padding entries have
    src = dst = -1, val = 0."""

    src: torch.Tensor   # (m,) int32 global src vertex (owned by the shard)
    dst: torch.Tensor   # (m,) int32 global dst vertex
    val: torch.Tensor   # (m,) f32
    n_vertices: int
    n_shards: int
    rank: int

    @property
    def edges_per_shard(self) -> int:
        return int(self.src.shape[0])


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Stacked per-shard edge lists on the host (CPU tensors).  Padding
    entries have src = dst = -1, val = 0."""

    src: torch.Tensor   # (S, m) int32
    dst: torch.Tensor   # (S, m) int32
    val: torch.Tensor   # (S, m) f32
    n_vertices: int
    n_shards: int

    @property
    def edges_per_shard(self) -> int:
        return int(self.src.shape[1])

    def shard(self, rank: int, device) -> GraphShard:
        """Rank ``rank``'s row of the stacked arrays, on ``device``."""
        return GraphShard(self.src[rank].to(device), self.dst[rank].to(device),
                          self.val[rank].to(device), self.n_vertices,
                          self.n_shards, int(rank))


def local_shard(g, mesh) -> GraphShard:
    """This rank's edge list on its device: a :class:`GraphShard` as
    given, or the rank's row of a stacked :class:`ShardedGraph`."""
    if g.n_shards != mesh.size:
        raise ValueError(f"the graph has {g.n_shards} shards, the mesh "
                         f"{mesh.size} ranks")
    if isinstance(g, GraphShard):
        if g.rank != mesh.rank:
            raise ValueError(f"rank {mesh.rank} was given shard {g.rank}")
        return g
    return g.shard(mesh.rank, mesh.device)


def _host_coo(csr: CSR):
    indptr = csr.indptr.cpu().numpy()
    cols = csr.indices.cpu().numpy()
    vals = (csr.values.cpu().numpy() if csr.values is not None
            else np.ones_like(cols, np.float32))
    rows = np.repeat(np.arange(csr.n_rows), np.diff(indptr))
    return indptr, rows, cols, vals


def shard_graph(csr: CSR, n_shards: int, row_att: Optional[ATT] = None
                ) -> tuple[ShardedGraph, ATT]:
    """Partition edges by *source-row ownership* under ``row_att``
    (default: the paper's degree-balanced contiguous partition), on the
    host.  Returns the stacked :class:`ShardedGraph` and the rule."""
    indptr, rows, cols, vals = _host_coo(csr)
    if row_att is None:
        row_att = degree_balanced_rule(indptr, n_shards)
    owner = row_att.owner(torch.from_numpy(rows)).numpy()
    counts = np.bincount(owner, minlength=n_shards)
    m = max(int(counts.max()) if counts.size else 1, 1)
    S = n_shards
    src_b = np.full((S, m), -1, np.int32)
    dst_b = np.full((S, m), -1, np.int32)
    val_b = np.zeros((S, m), np.float32)
    for s in range(S):
        sel = owner == s
        k = int(counts[s]) if s < counts.size else 0
        src_b[s, :k] = rows[sel]
        dst_b[s, :k] = cols[sel]
        val_b[s, :k] = vals[sel]
    g = ShardedGraph(torch.from_numpy(src_b), torch.from_numpy(dst_b),
                     torch.from_numpy(val_b), csr.n_rows, S)
    return g, row_att


def update_shards(gsh, csr, att, shards):
    """Rebuild only some shards' rows after a streaming update: not ported
    yet (ROADMAP §A.8)."""
    raise NotImplementedError("update_shards is not ported yet: it comes "
                              "with the distributed repairs (ROADMAP §A.8)")


def shard_vertex_array(x, att: ATT) -> torch.Tensor:
    """Host-side: lay a global vertex array out as (S, per_shard, ...)
    under ``att`` (padding slots zero)."""
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    out = np.zeros((att.n_shards, att.per_shard) + x.shape[1:], x.dtype)
    gid = torch.arange(att.n_global)
    out[att.owner(gid).numpy(), att.local(gid).numpy()] = x
    return torch.from_numpy(out)


def unshard_vertex_array(xs, att: ATT) -> torch.Tensor:
    """Inverse of :func:`shard_vertex_array`: (S, per, ...) ->
    (n_global, ...), on the host."""
    xs = xs.cpu() if isinstance(xs, torch.Tensor) else \
        torch.from_numpy(np.asarray(xs))
    gid = torch.arange(att.n_global)
    return xs[att.owner(gid), att.local(gid)]
