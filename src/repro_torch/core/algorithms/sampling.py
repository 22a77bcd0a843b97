"""Graph sampling: TIES (the paper's Table II) and layered neighbour
sampling (GNN), local placement.

TIES = Totally Induced Edge Sampling (Ahmed et al.): sample edges uniformly,
keep the induced subgraph on their endpoints.

`neighbor_sample` is the GraphSAGE-style layered fanout sampler:
with-replacement sampling straight out of the CSR, each layer one
`engine.sample_neighbors` pass.  Draws come from keyed splitmix64
(`engine.fold_in`), not the reference's threefry, so the two packages agree
in distribution, not in bits; a key gives the same draws on the CPU and the
card.  `neighbor_sample_np` is the host-side (data pipeline) version,
byte-equal to the reference's for the same `np.random.Generator`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import engine, offload
from ..graph import CSR

__all__ = ["ties_sample", "neighbor_sample", "neighbor_sample_np"]


def ties_sample(csr: CSR, n_edges_sample: int, max_nodes: int, key):
    """Returns (node_set (max_nodes,) int32 padded with -1, n_nodes () int32,
    induced_edge_mask (nnz,) bool), on the CSR's device.

    ``n_edges_sample`` edge ids are drawn uniformly from ``key`` (an int64
    key, :func:`engine.as_key`); the node set is the sorted unique
    endpoints (the first ``max_nodes``), and an edge is induced when both
    of its endpoints are in it.
    """
    dev = csr.device
    nnz = csr.nnz
    rows = csr.row_ids()
    k = engine.as_key(key, dev)
    z = engine.fold_in(k, torch.arange(n_edges_sample, device=dev))
    eids = engine._srl(z, 1) % max(nnz, 1)
    srcs = offload.dma_gather(rows, eids)
    dsts = offload.dma_gather(csr.indices, eids)
    cand = torch.sort(torch.cat([srcs, dsts]).to(torch.int32)).values
    keep = torch.ones_like(cand, dtype=torch.bool)
    keep[1:] = cand[1:] != cand[:-1]
    # compact the unique ids to a prefix, pad with -1
    order = torch.sort((~keep).to(torch.int8), stable=True).indices
    n_uniq = keep.sum()
    uniq = torch.where(torch.arange(cand.shape[0], device=dev) < n_uniq,
                       cand[order], -1)
    node_set = uniq[:max_nodes]
    if node_set.shape[0] < max_nodes:
        node_set = torch.cat([node_set, node_set.new_full(
            (max_nodes - node_set.shape[0],), -1)])
    # induced edges: both endpoints in the (sorted-prefix) node set
    sorted_set = torch.sort(torch.where(node_set >= 0, node_set,
                                        offload.LABEL_PAD)).values

    def member(v):
        pos = torch.clamp(torch.searchsorted(sorted_set, v.to(torch.int32)),
                          0, max_nodes - 1)
        return sorted_set[pos] == v

    mask = member(rows) & member(csr.indices)
    return node_set, torch.clamp(n_uniq, max=max_nodes).to(torch.int32), mask


def neighbor_sample(csr: CSR, seeds, fanouts: Sequence[int], key):
    """Layered with-replacement fanout sampling, on the CSR's device.

    Returns a list of int32 node-id tensors: [seeds (B,), (B, f1),
    (B, f1, f2), ...].  Sinks self-sample (id repeated), keeping shapes
    static.  Layer ``l`` replicates every query f times — one slot per
    draw, keyed ``fold_in(fold_in(key, l), slot)`` — and runs one
    unweighted `engine.sample_neighbors` step over the flattened slots.
    """
    dev = csr.device
    k = engine.as_key(key, dev)
    cur = torch.as_tensor(seeds, device=dev).to(torch.int32)
    layers = [cur]
    for layer, f in enumerate(fanouts):
        flat = torch.repeat_interleave(cur.reshape(-1), f)
        keys = engine.fold_in(engine.fold_in(k, layer),
                              torch.arange(flat.shape[0], device=dev))
        cur = engine.sample_neighbors(csr, flat, keys).reshape(
            cur.shape + (f,))
        layers.append(cur)
    return layers


def neighbor_sample_np(indptr: np.ndarray, indices: np.ndarray,
                       seeds: np.ndarray, fanouts: Sequence[int],
                       rng: np.random.Generator):
    """Host-side (data pipeline) version of neighbor_sample."""
    layers = [seeds.astype(np.int32)]
    cur = seeds.astype(np.int64)
    for f in fanouts:
        flat = cur.reshape(-1)
        start = indptr[flat]
        deg = indptr[flat + 1] - start
        r = rng.integers(0, 1 << 30, (flat.shape[0], f))
        off = start[:, None] + r % np.maximum(deg, 1)[:, None]
        nbr = indices[np.minimum(off, indices.shape[0] - 1)]
        nbr = np.where(deg[:, None] > 0, nbr, flat[:, None])
        nxt = nbr.reshape(cur.shape + (f,)).astype(np.int32)
        layers.append(nxt)
        cur = nxt
    return layers
