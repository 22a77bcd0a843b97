"""Synthetic data pipelines (counterpart of ``repro.data.synthetic``): LM
token streams, GNN graph batches (with the geometric extras DimeNet and
EquiformerV2 need), recsys click batches, and a host-side prefetch
iterator.

Everything is seeded numpy on the host, the reference's code draw for draw,
so a seed gives the same bytes in both packages; batches move to the
device at the model's call.  Only :func:`graph_for_shape` builds on a
device (CUDA unless ``device`` says otherwise), since it returns a CSR.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from ..core.graph import CSR, rmat, uniform_random_graph
from ..core.algorithms.sampling import neighbor_sample_np

__all__ = ["lm_batches", "gnn_batch", "sampled_gnn_batch", "recsys_batches",
           "prefetch", "build_triplets", "build_wigner", "graph_for_shape"]


def lm_batches(batch: int, seq: int, vocab: int, *,
               seed: int = 0) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    while True:
        # zipf-ish marginal so embedding gathers see realistic skew
        z = rng.zipf(1.3, size=(batch, seq))
        yield {"tokens": (z % vocab).astype(np.int32)}


def recsys_batches(batch: int, n_fields: int, rows_per_field: int, *,
                   seed: int = 0) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    while True:
        local = rng.zipf(1.2, size=(batch, n_fields)) % rows_per_field
        ids = (local + np.arange(n_fields)[None, :] * rows_per_field
               ).astype(np.int32)
        # planted linear model for learnable labels
        w = np.sin(ids * 0.001).sum(-1)
        labels = (w + rng.standard_normal(batch) * 0.1 > 0).astype(np.float32)
        yield {"ids": ids, "labels": labels}


# ---------------------------------------------------------------------------
# GNN batches
# ---------------------------------------------------------------------------

def build_triplets(src: np.ndarray, dst: np.ndarray, pos: np.ndarray,
                   max_triplets: int, *, seed: int = 0):
    """(k->j) feeding (j->i) triplet lists + bond angle at j."""
    E = src.shape[0]
    by_dst: dict[int, list[int]] = {}
    for e in range(E):
        by_dst.setdefault(int(dst[e]), []).append(e)
    t_kj, t_ji = [], []
    for e2 in range(E):
        j = int(src[e2])
        for e1 in by_dst.get(j, ()):
            if int(src[e1]) == int(dst[e2]):
                continue
            t_kj.append(e1)
            t_ji.append(e2)
            if len(t_kj) >= max_triplets:
                break
        if len(t_kj) >= max_triplets:
            break
    n = len(t_kj)
    t_kj = np.array(t_kj + [-1] * (max_triplets - n), np.int32)
    t_ji = np.array(t_ji + [0] * (max_triplets - n), np.int32)
    # angle at j between (k - j) and (i - j)
    safe_kj = np.maximum(t_kj, 0)
    k_, j_, i_ = src[safe_kj], dst[safe_kj], dst[np.maximum(t_ji, 0)]
    v1 = pos[k_] - pos[j_]
    v2 = pos[i_] - pos[j_]
    cos = (v1 * v2).sum(-1) / (np.linalg.norm(v1, axis=-1) *
                               np.linalg.norm(v2, axis=-1) + 1e-9)
    angle = np.arccos(np.clip(cos, -1, 1)).astype(np.float32)
    return t_kj, t_ji, angle


def _rotation_to_y(vec: np.ndarray) -> np.ndarray:
    """Batch of 3x3 rotations sending each vec to the +y axis (eSCN frame)."""
    v = vec / (np.linalg.norm(vec, axis=-1, keepdims=True) + 1e-9)
    y = np.array([0.0, 1.0, 0.0])
    c = v @ y
    ax = np.cross(v, np.broadcast_to(y, v.shape))
    s = np.linalg.norm(ax, axis=-1, keepdims=True)
    ax = ax / (s + 1e-9)
    K = np.zeros(v.shape[:-1] + (3, 3), np.float32)
    K[..., 0, 1], K[..., 0, 2] = -ax[..., 2], ax[..., 1]
    K[..., 1, 0], K[..., 1, 2] = ax[..., 2], -ax[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -ax[..., 1], ax[..., 0]
    eye = np.eye(3, dtype=np.float32)
    sin = s[..., None]
    cos = c[..., None, None]
    return (eye + sin * K + (1 - cos) * (K @ K)).astype(np.float32)


def build_wigner(src: np.ndarray, dst: np.ndarray, pos: np.ndarray,
                 l_max: int) -> np.ndarray:
    """Per-edge block-diagonal rotation in the irrep basis: l=0 -> 1,
    l=1 -> the geometric rotation, l>=2 -> identity blocks (the reference's
    synthetic-pipeline simplification)."""
    E = src.shape[0]
    ncoef = (l_max + 1) ** 2
    W = np.tile(np.eye(ncoef, dtype=np.float32), (E, 1, 1))
    vec = pos[np.maximum(dst, 0)] - pos[np.maximum(src, 0)]
    vec[np.linalg.norm(vec, axis=-1) < 1e-6] = np.array([0, 1, 0], np.float32)
    R = _rotation_to_y(vec)
    if l_max >= 1:
        W[:, 1:4, 1:4] = R
    return W


def graph_for_shape(shape_name: str, *, seed: int = 0,
                    scale_override: Optional[int] = None,
                    device=None) -> CSR:
    """Representative synthetic graph per GNN shape (scaled for a smoke
    run), built on ``device``."""
    if shape_name == "full_graph_sm":
        return uniform_random_graph(2708, 4, seed=seed, device=device)
    if shape_name == "molecule":
        return uniform_random_graph(30, 2, seed=seed, device=device)
    return rmat(scale_override or 10, 8, seed=seed, device=device)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def gnn_batch(arch: str, csr: CSR, d_feat: int, n_classes: int, *,
              l_max: int = 6, max_triplets: Optional[int] = None,
              graph_id: Optional[np.ndarray] = None, seed: int = 0,
              label_mask: Optional[np.ndarray] = None) -> dict:
    rng = np.random.default_rng(seed)
    n = csr.n_rows
    src = _host(csr.row_ids()).astype(np.int32)
    dst = _host(csr.indices).astype(np.int32)
    b = {
        "x": rng.standard_normal((n, d_feat)).astype(np.float32),
        "src": src, "dst": dst,
        "labels": rng.integers(0, n_classes, n).astype(np.int32),
    }
    if arch in ("dimenet", "equiformer_v2"):
        b["pos"] = rng.standard_normal((n, 3)).astype(np.float32) * 3.0
    if arch == "dimenet":
        mt = max_triplets or min(4 * src.shape[0], 20000)
        t_kj, t_ji, angle = build_triplets(src, dst, b["pos"], mt, seed=seed)
        b.update(triplet_kj=t_kj, triplet_ji=t_ji, angle=angle)
    if arch == "equiformer_v2":
        b["wigner"] = build_wigner(src, dst, b["pos"], l_max)
    if graph_id is not None:
        b["graph_id"] = graph_id
    if label_mask is not None:
        b["label_mask"] = label_mask
    return b


def sampled_gnn_batch(csr: CSR, features: np.ndarray, labels: np.ndarray,
                      batch_nodes: int, fanouts: Sequence[int], *,
                      seed: int = 0) -> dict:
    """minibatch_lg: layered sample flattened to an edge list over local ids.

    Node order: [seeds | hop1 | hop2 ...]; every sampled neighbor contributes
    one edge child->parent.  Loss is masked to the seed nodes.
    """
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, csr.n_rows, batch_nodes)
    layers = neighbor_sample_np(_host(csr.indptr), _host(csr.indices),
                                seeds, fanouts, rng)
    flat_ids = [l.reshape(-1) for l in layers]
    offsets = np.cumsum([0] + [f.shape[0] for f in flat_ids])
    src_l, dst_l = [], []
    for h in range(1, len(layers)):
        parent_local = np.arange(flat_ids[h - 1].shape[0]) + offsets[h - 1]
        child_local = np.arange(flat_ids[h].shape[0]) + offsets[h]
        src_l.append(child_local)
        dst_l.append(np.repeat(parent_local, layers[h].shape[-1]))
    all_ids = np.concatenate(flat_ids)
    mask = np.zeros(all_ids.shape[0], bool)
    mask[:batch_nodes] = True
    return {
        "x": features[all_ids].astype(np.float32),
        "src": np.concatenate(src_l).astype(np.int32),
        "dst": np.concatenate(dst_l).astype(np.int32),
        "labels": labels[all_ids].astype(np.int32),
        "label_mask": mask,
    }


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Host-side background prefetch (offload-engine analogue for input
    data)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(stop)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item
