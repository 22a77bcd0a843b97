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
from typing import Callable, Iterator, NamedTuple, Optional, Sequence

import numpy as np

from ..core.graph import CSR, rmat, uniform_random_graph
from ..core.algorithms.sampling import neighbor_sample_np

__all__ = ["lm_batches", "gnn_batch", "sampled_gnn_batch", "recsys_batches",
           "prefetch", "build_triplets", "build_wigner", "graph_for_shape",
           "Rows", "triplet_rows", "wigner_rows", "gnn_inputs"]


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

class Rows(NamedTuple):
    """Arrays of ``length`` rows given by their rows: ``build(lo, hi)``
    returns {key: rows lo to hi - 1} (0 <= lo <= hi <= length) of every
    key in ``keys``, so a rank of a mesh builds only its block of them
    (``models.gnn.local_batch``, which finds the object under each of its
    keys of a batch)."""

    keys: tuple
    length: int
    build: Callable

    def entries(self) -> dict:
        """{key: self} for each of its keys, to put into a batch."""
        return dict.fromkeys(self.keys, self)


def _triplet_plan(src: np.ndarray, dst: np.ndarray) -> tuple:
    """(edges sorted by destination, stably; their offsets by destination
    node; each edge e2's first triplet index, one past the last at the
    end).  Edge e2 = (j -> i) is fed by every edge e1 into j whose source
    is not i, in edge order."""
    n = int(max(src.max(), dst.max())) + 1 if src.size else 1
    order = np.argsort(dst, kind="stable")
    ptr = np.searchsorted(dst[order], np.arange(n + 1))
    indeg = ptr[src + 1] - ptr[src]
    # the fed edges whose source is i: copies of the reverse edge (i -> j)
    key = src.astype(np.int64) * n + dst
    uniq, mult = np.unique(key, return_counts=True)
    rkey = dst.astype(np.int64) * n + src
    rev = np.zeros_like(indeg)
    if uniq.size:
        at = np.minimum(np.searchsorted(uniq, rkey), uniq.size - 1)
        rev = np.where(uniq[at] == rkey, mult[at], 0)
    off = np.concatenate([[0], np.cumsum(indeg - rev)]).astype(np.int64)
    return order, ptr, off


def triplet_rows(src: np.ndarray, dst: np.ndarray, pos: np.ndarray,
                 max_triplets: Optional[int] = None) -> Rows:
    """:class:`Rows` of :func:`build_triplets`' arrays ('triplet_kj',
    'triplet_ji', 'angle'; ``max_triplets`` rows, by default min(4 E,
    20,000)), a range of rows built from the edges it needs alone."""
    mt = max_triplets or min(4 * src.shape[0], 20000)
    order, ptr, off = _triplet_plan(src, dst)
    real = int(min(off[-1], mt))

    def rows(lo: int, hi: int) -> dict:
        top = max(min(hi, real), lo)
        kj = np.full(hi - lo, -1, np.int32)
        ji = np.zeros(hi - lo, np.int32)
        if top > lo:
            # the feeding edges of every e2 whose triplets meet [lo, top)
            ea = int(np.searchsorted(off, lo, "right")) - 1
            eb = int(np.searchsorted(off, top - 1, "right")) - 1
            e2 = np.arange(ea, eb + 1)
            j = src[e2]
            lens = ptr[j + 1] - ptr[j]
            first = np.repeat(ptr[j] - np.cumsum(lens) + lens, lens)
            e1 = order[first + np.arange(int(lens.sum()))]
            e2 = np.repeat(e2, lens)
            keep = src[e1] != dst[e2]
            at = lo - int(off[ea])
            kj[:top - lo] = e1[keep][at:at + top - lo]
            ji[:top - lo] = e2[keep][at:at + top - lo]
        # angle at j between (k - j) and (i - j); padding reads edge 0
        safe_kj = np.maximum(kj, 0)
        k_, j_, i_ = src[safe_kj], dst[safe_kj], dst[np.maximum(ji, 0)]
        v1 = pos[k_] - pos[j_]
        v2 = pos[i_] - pos[j_]
        cos = (v1 * v2).sum(-1) / (np.linalg.norm(v1, axis=-1) *
                                   np.linalg.norm(v2, axis=-1) + 1e-9)
        angle = np.arccos(np.clip(cos, -1, 1)).astype(np.float32)
        return {"triplet_kj": kj, "triplet_ji": ji, "angle": angle}

    return Rows(("triplet_kj", "triplet_ji", "angle"), mt, rows)


def build_triplets(src: np.ndarray, dst: np.ndarray, pos: np.ndarray,
                   max_triplets: int, *, seed: int = 0):
    """(k->j) feeding (j->i) triplet lists + bond angle at j: for each edge
    e2 = (j -> i) in order, every edge e1 into j (in order) whose source is
    not i, cut at ``max_triplets``; padded with kj -1, ji 0."""
    got = triplet_rows(src, dst, pos, max_triplets).build(0, max_triplets)
    return got["triplet_kj"], got["triplet_ji"], got["angle"]


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


def wigner_rows(src: np.ndarray, dst: np.ndarray, pos: np.ndarray,
                l_max: int) -> Rows:
    """:class:`Rows` of :func:`build_wigner`'s (E, ncoef, ncoef) blocks,
    a range built from its own edges."""
    return Rows(("wigner",), src.shape[0], lambda lo, hi: {
        "wigner": build_wigner(src[lo:hi], dst[lo:hi], pos, l_max)})


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


def gnn_inputs(arch: str, csr: CSR, d_feat: int, n_classes: int, *,
               seed: int = 0) -> dict:
    """A labelled batch's node and edge arrays over ``csr``'s edges (x,
    src, dst, labels, and pos for dimenet and equiformer-v2), without the
    geometry built from them (:func:`triplet_rows`, :func:`wigner_rows`),
    which a rank of a mesh builds at its own rows alone."""
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
    return b


def gnn_batch(arch: str, csr: CSR, d_feat: int, n_classes: int, *,
              l_max: int = 6, max_triplets: Optional[int] = None,
              graph_id: Optional[np.ndarray] = None, seed: int = 0,
              label_mask: Optional[np.ndarray] = None) -> dict:
    """A labelled batch over ``csr``'s edges (:func:`gnn_inputs`), with
    dimenet's triplets and equiformer-v2's Wigner blocks built whole."""
    b = gnn_inputs(arch, csr, d_feat, n_classes, seed=seed)
    if arch == "dimenet":
        rows = triplet_rows(b["src"], b["dst"], b["pos"], max_triplets)
        b.update(rows.build(0, rows.length))
    if arch == "equiformer_v2":
        rows = wigner_rows(b["src"], b["dst"], b["pos"], l_max)
        b.update(rows.build(0, rows.length))
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
