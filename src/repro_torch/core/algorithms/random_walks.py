"""Random walks — the paper's highest-speedup workload, local placement.

Pure pointer chasing: every step is two dependent fine-grained reads
(degree / offset from indptr, then the sampled neighbour from the edge
array).  Locally each step is one `engine.sample_neighbors` pass; this
module keeps only the loop over steps.  Distributed, a walker is a *queue
entry*: the walk runs on `engine.run_queue`, so the walkers are balanced
across the ranks by the queue engine (`offload.queue_balance`), and the
per-step reads are DGAS remote gathers against two ATT rules (vertex space
for indptr, edge space for indices).

Both forms key walker ``w``'s step ``t`` on ``fold_in(fold_in(key, t),
w)`` and take the same offset into the row, so the distributed walks
equal the local ones bit for bit, whatever the rank count and the
balancing cadence (the reference keys its distributed draws on (shard,
iteration) instead, so its walks depend on both).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import engine, offload
from ..dgas import block_rule
from ..graph import CSR

__all__ = ["random_walks", "random_walks_distributed", "walk_queue_program",
           "walk_shards"]


def random_walks(csr: CSR, starts, n_steps: int, key) -> torch.Tensor:
    """Uniform random walks: (n_walkers, n_steps + 1) int32 node ids on the
    CSR's device, column 0 the starts.

    Walkers at a sink (degree 0) stay in place.  Walker ``w`` draws step
    ``t`` from ``fold_in(fold_in(key, t), w)``, so walkers colliding on a
    vertex stay uncorrelated and a key gives the same walks on the CPU and
    the card.
    """
    dev = csr.device
    k = engine.as_key(key, dev)
    cur = torch.as_tensor(starts, device=dev).to(torch.int32)
    walkers = torch.arange(cur.shape[0], device=dev)
    path = torch.empty((n_steps + 1, cur.shape[0]), dtype=torch.int32,
                       device=dev)
    path[0] = cur
    for t in range(n_steps):
        cur = engine.sample_neighbors(csr, cur, engine.fold_in(
            engine.fold_in(k, t), walkers))
        path[t + 1] = cur
    return path.T.contiguous()


def walk_queue_program(v_att, e_att, mesh, cap: int) -> engine.QueueProgram:
    """One walk step as a queue program: items are walker ids, the payload
    each walker's current vertex.  The three reads (the row's start and
    end in indptr, then the drawn neighbour in indices) are fine-grained
    ``dgas_gather`` calls at capacity ``cap`` (a rank never holds more
    walkers).  The draw is :func:`engine.sample_neighbors`' unweighted
    one on the key ``fold_in(step key, walker)``."""

    def step_fn(operands, items, cur, state, it, key):
        indptr_sh, indices_sh = operands
        valid = items >= 0
        start = offload.dgas_gather(indptr_sh, torch.where(valid, cur, -1),
                                    v_att, mesh, capacity=cap).long()
        end = offload.dgas_gather(indptr_sh, torch.where(valid, cur + 1, -1),
                                  v_att, mesh, capacity=cap).long()
        deg = end - start
        z = engine._mix64(engine.fold_in(key, items.long()))
        off = start + engine._srl(z, 34) % torch.clamp(deg, min=1)
        nbr = offload.dgas_gather(indices_sh,
                                  torch.where(valid & (deg > 0), off, -1),
                                  e_att, mesh, capacity=cap)
        nxt = torch.where(valid, torch.where(deg > 0, nbr.to(torch.int32),
                                             cur), -1).to(torch.int32)
        return items, nxt, state, (items, nxt)

    return engine.QueueProgram(step_fn)


def walk_shards(indptr, indices, n_shards: int, rank: int):
    """Rank ``rank``'s blocks of a CSR's ``indptr`` (under a vertex-space
    block rule over its n + 1 entries) and ``indices`` (under an
    edge-space block rule), as CPU tensors, and the two rules: the
    operands of :func:`random_walks_distributed`.  The arrays are host
    arrays (numpy, a memory map or CPU tensors); only the rank's blocks
    are read."""
    out = []
    for arr in (indptr, indices):
        att = block_rule(len(arr), n_shards)
        lo, cnt = att.shard_slice(rank)
        blk = torch.from_numpy(np.array(arr[lo:lo + cnt]))
        out += [torch.cat([blk, blk.new_zeros(att.per_shard - cnt)]), att]
    return out[0], out[2], out[1], out[3]


def random_walks_distributed(indptr_local, indices_local, v_att, e_att,
                             starts, n_steps: int, key, mesh, *, axis=None):
    """Walker-parallel distributed walks on one rank of ``mesh``: every
    rank calls it with its own blocks of indptr (under ``v_att``, a
    vertex-space rule over n + 1 ids) and indices (under ``e_att``, an
    edge-space rule; :func:`walk_shards` makes both) and the same global
    ``starts``.  Walker w enqueues at its start vertex's owner under
    ``block_rule(n, S)`` (the natural DGAS placement), the queue capacity
    covers that skew and the balanced ceil(W / S), and the queue engine
    rebalances the walkers every step.  Rank 0
    stitches the per-step snapshots (``Mesh.gather``) into the
    (W, n_steps + 1) int32 paths, column 0 the starts, and returns them;
    the other ranks return None.  Equal to :func:`random_walks` on the
    same graph, starts and key."""
    mesh = mesh.over(axis)
    S, dev = mesh.size, mesh.device
    n = v_att.n_global - 1
    st = torch.as_tensor(np.asarray(starts.cpu() if isinstance(
        starts, torch.Tensor) else starts, np.int64))
    W = int(st.shape[0])
    owner = block_rule(n, S).owner(st)
    counts = torch.bincount(owner, minlength=S)
    cap = max(1, int(counts.max()) if W else 0, -(-W // S))
    mine = torch.nonzero(owner == mesh.rank).reshape(-1)
    items0 = torch.full((cap,), -1, dtype=torch.int32)
    cur0 = torch.zeros(cap, dtype=torch.int32)
    items0[:mine.numel()] = mine.to(torch.int32)
    cur0[:mine.numel()] = st[mine].to(torch.int32)
    prog = walk_queue_program(v_att, e_att, mesh, cap)
    _, (ids, vs) = engine.run_queue(
        mesh, prog, items0.to(dev), cur0.to(dev),
        (indptr_local, indices_local), n_iters=n_steps, key=key)
    ids, vs = mesh.gather(ids), mesh.gather(vs)    # (S, n_steps, cap)
    if ids is None:
        return None
    walks = torch.empty((W, n_steps + 1), dtype=torch.int32, device=dev)
    walks[:, 0] = st.to(dev).to(torch.int32)
    step = torch.arange(1, n_steps + 1, device=dev).reshape(1, -1, 1)
    step = step.expand_as(ids)
    sel = ids >= 0
    walks[ids[sel].long(), step[sel]] = vs[sel]
    return walks
