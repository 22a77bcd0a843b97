"""Distributed (DGAS-partitioned) graph representation, counterpart of
``repro.core.algorithms.distgraph``.

On the host: partition CSR rows with a programmable ATT rule (default:
the paper's degree-balanced rule) into *stacked* per-shard COO arrays with
identical padding, built exactly as the reference builds them.  Each rank
then takes its own row onto its device (:meth:`ShardedGraph.shard`), or
builds it from a CSR it holds (:func:`shard_of`).  A streaming update
rebuilds only the touched shards (:func:`update_shards`), on the host or
on each rank.

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
from ...obs import get_registry

__all__ = ["ShardedGraph", "GraphShard", "shard_graph", "local_shard",
           "shard_of", "update_shards", "shard_vertex_array",
           "unshard_vertex_array"]


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


def _rank_edges(csr: CSR, att: ATT, rank: int):
    """(src, dst, val) of the rows ``rank`` owns under ``att``, in CSR
    order, on the CSR's device (a slice for a contiguous rule)."""
    if att.kind in ("block", "boundaries"):
        lo, cnt = att.shard_slice(rank)
        a, b = int(csr.indptr[lo]), int(csr.indptr[lo + cnt])
        rows = csr.row_ids()[a:b]
        sl = slice(a, b)
    else:
        rows = csr.row_ids()
        sl = att.owner(rows) == rank
        rows = rows[sl]
    vals = csr.values[sl] if csr.values is not None else \
        torch.ones(rows.shape[0], dtype=torch.float32, device=csr.device)
    return rows.to(torch.int32), csr.indices[sl].to(torch.int32), \
        vals.to(torch.float32)


def _padded(src, dst, val, m: int, n: int, S: int, rank: int, device
            ) -> GraphShard:
    k = int(src.shape[0])
    out = [torch.full((m,), -1, dtype=torch.int32, device=device),
           torch.full((m,), -1, dtype=torch.int32, device=device),
           torch.zeros(m, dtype=torch.float32, device=device)]
    for o, x in zip(out, (src, dst, val)):
        o[:k] = x
    return GraphShard(*out, n, S, int(rank))


def _owner_counts(csr: CSR, att: ATT) -> np.ndarray:
    """Edges per shard of ``csr`` under ``att`` (host ints)."""
    if att.kind in ("block", "boundaries"):
        ip = csr.indptr.cpu().numpy().astype(np.int64)
        cuts = [att.shard_slice(s) for s in range(att.n_shards)]
        return np.array([ip[lo + c] - ip[lo] for lo, c in cuts], np.int64)
    return torch.bincount(att.owner(csr.row_ids()).long(),
                          minlength=att.n_shards).cpu().numpy()


def shard_of(csr: CSR, att: ATT, rank: int, *, device=None) -> GraphShard:
    """Rank ``rank``'s :class:`GraphShard` of ``csr`` under ``att`` (its
    source rows, in CSR order), padded to the most edges any shard holds
    (as :func:`shard_graph` pads), on ``device`` (default: the CSR's).
    Equal to ``shard_graph(csr, S, row_att=att)[0].shard(rank, device)``,
    built from the rank's own rows."""
    m = max(int(_owner_counts(csr, att).max()), 1)
    src, dst, val = _rank_edges(csr, att, rank)
    return _padded(src, dst, val, m, csr.n_rows, att.n_shards, rank,
                   csr.device if device is None else device)


def update_shards(gsh, csr: CSR, att: ATT, shards, mesh=None):
    """Rebuild only ``shards``' edge lists from the (updated) ``csr`` — the
    streaming-ingest reshard: an update batch whose changed edges all live
    in a few partitions reships only those partitions' edge lists.

    On the host, ``gsh`` is the stacked :class:`ShardedGraph`: the patched
    graph's arrays equal the reference's bit for bit.  On a rank, ``gsh``
    is its :class:`GraphShard` and ``mesh`` its mesh: the rank rebuilds
    its own edge list only when it is one of ``shards`` (every rank passes
    the same ``shards``), and one all-reduce of the overflow flag makes
    every rank take the same branch.

    Returns the patched graph (the same object when ``shards`` is empty),
    or None — on every rank at once — when a touched shard's new edge
    count exceeds the padding (``edges_per_shard``): the caller then
    reshards in full.  The fallback counts as
    ``streaming.reshard_fallback`` in the port's registry."""
    shards = sorted({int(s) for s in np.asarray(shards).reshape(-1)})
    m = gsh.edges_per_shard
    if isinstance(gsh, GraphShard):
        if mesh is None:
            raise ValueError("update_shards on a rank's GraphShard needs its "
                             "mesh: the overflow decision is all-reduced")
        if not shards:
            return gsh
        mine = gsh.rank in shards
        if mine:
            src, dst, val = _rank_edges(csr, att, gsh.rank)
        over = torch.tensor([int(mine and src.shape[0] > m)],
                            dtype=torch.int32, device=mesh.device)
        if int(mesh.all_reduce(over, "max")[0]):
            get_registry().counter("streaming.reshard_fallback").inc()
            return None
        if not mine:
            return gsh
        return _padded(src, dst, val, m, csr.n_rows, gsh.n_shards, gsh.rank,
                       gsh.src.device)
    if not shards:
        return gsh
    indptr, rows, cols, vals = _host_coo(csr)
    owner = att.owner(torch.from_numpy(rows)).numpy()
    src_b, dst_b = gsh.src.numpy().copy(), gsh.dst.numpy().copy()
    val_b = gsh.val.numpy().copy()
    for s in shards:
        sel = owner == s
        k = int(sel.sum())
        if k > m:
            get_registry().counter("streaming.reshard_fallback").inc()
            return None
        src_b[s, :k], dst_b[s, :k], val_b[s, :k] = rows[sel], cols[sel], \
            vals[sel]
        src_b[s, k:], dst_b[s, k:], val_b[s, k:] = -1, -1, 0.0
    return ShardedGraph(torch.from_numpy(src_b), torch.from_numpy(dst_b),
                        torch.from_numpy(val_b), csr.n_rows, gsh.n_shards)


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
