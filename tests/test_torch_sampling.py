"""Port checks for sampling: the engine's 'sample' combine, the unweighted
and weighted ``engine.sample_neighbors``, ``random_walks``,
``neighbor_sample``, ``neighbor_sample_np`` and ``ties_sample``.

The port draws from keyed splitmix64 (``engine.fold_in``), the reference
from threefry, which torch cannot replay, so the draws are held to
distributions and invariants, not to the reference's bits: every pick is a
real out-neighbour and sinks stay put; a chi-square test over a hub's
picks at a fixed key (deterministic, so it cannot flake) passes at
p > 1e-4; the 'sample' combine picks alike in push and pull.
``neighbor_sample_np`` is numpy and byte-equal to the reference's.
"""
import numpy as np
import pytest
import scipy.stats
import torch

from repro.core import graph as RG
from repro.core.algorithms import sampling as RS
from repro_torch.core import algorithms as TA
from repro_torch.core import engine as TE
from repro_torch.core import graph as TG
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

G = TG.csr_from_numpy(*(lambda g: (np.asarray(g.indptr),
                                   np.asarray(g.indices),
                                   np.asarray(g.values), g.n_rows,
                                   g.n_cols))(RG.rmat(10, 8, seed=21)),
                      device="cpu")
DRAWS = 24_000


def _edge_set(g):
    return set(zip(g.row_ids().tolist(), g.indices.tolist()))


EDGES = _edge_set(G)
SINKS = torch.nonzero(G.degrees() == 0).squeeze(1)


def _valid_steps(frm, to):
    """Every (frm, to) pair is an edge, or frm is a sink and to == frm."""
    for a, b in zip(frm.tolist(), to.tolist()):
        if (a, b) not in EDGES and not (G.degrees()[a] == 0 and a == b):
            return False
    return True


def _sample_program(edge_op):
    def msg_fn(state, frontier):
        return torch.where(frontier > 0, state["v"], -1)

    def update_fn(state, acc, frontier, it):
        return ({"v": state["v"], "best": acc[0], "pick": acc[1]},
                torch.zeros_like(frontier))

    return TE.VertexProgram(edge_op=edge_op, combine="sample",
                            msg_fn=msg_fn, update_fn=update_fn)


@pytest.mark.parametrize("edge_op", ["copy", "mul"])
def test_sample_combine_push_equals_pull(edge_op):
    """Keyed on the edge's CSR position, the draw is the same in both
    directions; each pick is an active in-neighbour, a vertex with none
    gets (-inf, -1), and another key draws other picks."""
    n = G.n_rows
    f0 = torch.from_numpy((np.random.default_rng(2).random(n) < 0.4)
                          .astype(np.int32))
    v0 = torch.arange(n, dtype=torch.int32)
    runs = {m: TE.run(G, _sample_program(edge_op), {"v": v0}, f0,
                      max_iters=1, mode=m, key=77)
            for m in ("push", "pull", "auto")}
    for m in ("pull", "auto"):
        assert torch.equal(runs[m]["pick"], runs["push"]["pick"])
        assert torch.equal(runs[m]["best"], runs["push"]["best"])
    pick = runs["push"]["pick"]
    has = torch.zeros(n, dtype=torch.bool)
    rows, cols = G.index64()
    has[cols[f0[rows] > 0]] = True
    assert torch.equal(pick >= 0, has)
    assert bool(torch.isinf(runs["push"]["best"][~has]).all())
    v = torch.nonzero(has).squeeze(1)
    assert all((int(p), int(d)) in EDGES and f0[p] for p, d in
               zip(pick[v], v))
    other = TE.run(G, _sample_program(edge_op), {"v": v0}, f0, max_iters=1,
                   mode="pull", key=78)["pick"]
    assert not torch.equal(other, pick)


def _hub_counts(weighted, key):
    hub = int(torch.argmax(G.degrees()))
    keys = TE.fold_in(torch.tensor(key), torch.arange(DRAWS))
    picks = TE.sample_neighbors(G, torch.full((DRAWS,), hub), keys,
                                weighted=weighted)
    lo, hi = int(G.indptr[hub]), int(G.indptr[hub + 1])
    cols = G.indices[lo:hi]
    pos = torch.searchsorted(cols, picks)
    assert bool((cols[pos.clamp(max=hi - lo - 1)] == picks).all())
    return torch.bincount(pos, minlength=hi - lo).numpy(), \
        G.values[lo:hi].double().numpy()


def pooled_chisquare(counts, expected):
    """Chi-square p-value with the bins expected below 5 pooled into one
    (the test's approximation needs about 5 a bin)."""
    low = expected < 5
    if low.any():
        counts = np.r_[counts[~low], counts[low].sum()]
        expected = np.r_[expected[~low], expected[low].sum()]
    return scipy.stats.chisquare(counts, expected)


@pytest.mark.parametrize("weighted", [False, True])
def test_sample_neighbors_chi_square(weighted):
    """24,000 draws at the largest hub (fixed key): counts proportional to
    1 (unweighted) or to the edge value (weighted), chi-square p > 1e-4."""
    counts, w = _hub_counts(weighted, 9)
    p = w / w.sum() if weighted else np.full(w.size, 1.0 / w.size)
    stat, pval = pooled_chisquare(counts, DRAWS * p)
    assert counts.sum() == DRAWS and pval > 1e-4, (stat, pval)


@pytest.mark.parametrize("weighted", [False, True])
def test_sample_neighbors_invariants(weighted):
    """Picks are real out-neighbours; sinks and negative queries return the
    query; a slot's draw does not depend on the batch around it; a row of
    zero weights gives its first entry (the reference's argmax)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(np.r_[rng.integers(0, G.n_rows, 300),
                               SINKS[:5].numpy(), [-1, -4]])
    keys = TE.fold_in(torch.tensor(11), torch.arange(q.numel()))
    got = TE.sample_neighbors(G, q, keys, weighted=weighted)
    assert got.dtype == torch.int32 and got.shape == q.shape
    assert _valid_steps(q[:-2], got[:-2])
    assert got[-2:].tolist() == [-1, -4]
    assert bool((got[300:305] == q[300:305]).all())
    alone = TE.sample_neighbors(G, q[7:9], keys[7:9], weighted=weighted)
    assert torch.equal(alone, got[7:9])
    if weighted:
        z = TG.CSR(G.indptr, G.indices, torch.zeros_like(G.values),
                   G.n_rows, G.n_cols)
        v = int(torch.argmax(G.degrees()))
        one = TE.sample_neighbors(z, torch.tensor([v]), keys[:1],
                                  weighted=True)
        assert int(one) == int(G.indices[G.indptr[v]])


def test_weighted_draw_skips_nonpositive_values():
    """Entries whose value is 0 or negative are never drawn; the rest of
    the row still is, in proportion (chi-square p > 1e-4)."""
    hub = int(torch.argmax(G.degrees()))
    lo, hi = int(G.indptr[hub]), int(G.indptr[hub + 1])
    vals = G.values.clone()
    vals[lo:hi:3] = 0.0
    vals[lo + 1:hi:3] = -1.0
    g = TG.CSR(G.indptr, G.indices, vals, G.n_rows, G.n_cols)
    keys = TE.fold_in(torch.tensor(12), torch.arange(DRAWS))
    picks = TE.sample_neighbors(g, torch.full((DRAWS,), hub), keys,
                                weighted=True)
    pos = torch.searchsorted(G.indices[lo:hi], picks)
    counts = torch.bincount(pos, minlength=hi - lo).numpy()
    w = vals[lo:hi].double().numpy()
    assert counts[w <= 0].sum() == 0
    live = w > 0
    assert pooled_chisquare(counts[live],
                            DRAWS * w[live] / w[live].sum())[1] > 1e-4


def test_random_walks_valid():
    starts = torch.cat([torch.arange(200), SINKS[:3]])
    walks = TA.random_walks(G, starts, 12, 5)
    assert walks.shape == (starts.numel(), 13) and walks.dtype == torch.int32
    assert torch.equal(walks[:, 0], starts.to(torch.int32))
    assert _valid_steps(walks[:, :-1].reshape(-1), walks[:, 1:].reshape(-1))
    assert bool((walks[-3:] == SINKS[:3, None]).all())
    assert torch.equal(TA.random_walks(G, starts, 12, 5), walks)
    assert not torch.equal(TA.random_walks(G, starts, 12, 6), walks)


def test_neighbor_sample_shapes_and_picks():
    seeds = torch.tensor([0, 5, 9, int(SINKS[0])])
    layers = TA.neighbor_sample(G, seeds, (4, 3), key=8)
    assert [tuple(x.shape) for x in layers] == [(4,), (4, 4), (4, 4, 3)]
    assert all(x.dtype == torch.int32 for x in layers)
    assert _valid_steps(layers[0].repeat_interleave(4), layers[1].reshape(-1))
    assert _valid_steps(layers[1].reshape(-1).repeat_interleave(3),
                        layers[2].reshape(-1))
    assert bool((layers[2][3] == SINKS[0]).all())


def test_neighbor_sample_np_byte_equal():
    indptr, indices = G.indptr.numpy(), G.indices.numpy()
    seeds = np.array([0, 3, 77, int(SINKS[0])], np.int32)
    got = TA.neighbor_sample_np(indptr, indices, seeds, (5, 2),
                                np.random.default_rng(13))
    want = RS.neighbor_sample_np(indptr, indices, seeds, (5, 2),
                                 np.random.default_rng(13))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_ties_sample_invariants():
    node_set, n_nodes, mask = TA.ties_sample(G, 40, 128, key=3)
    k = int(n_nodes)
    assert node_set.shape == (128,) and 0 < k <= 80
    nodes = node_set[:k]
    assert bool((nodes[1:] > nodes[:-1]).all()) and bool(
        (node_set[k:] == -1).all())
    rows, cols = G.row_ids(), G.indices
    inside = torch.isin(rows, nodes) & torch.isin(cols, nodes)
    assert torch.equal(mask, inside) and int(mask.sum()) >= 1
    # every node is an endpoint of an edge the mask keeps
    assert bool(torch.isin(nodes, torch.cat([rows[mask], cols[mask]])).all())
    small, n_small, _ = TA.ties_sample(G, 40, 8, key=3)
    assert int(n_small) == 8 and torch.equal(small, node_set[:8])
