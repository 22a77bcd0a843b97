"""Port parity for the structured combines: ``repro_torch``'s offload
primitives (``segment_argmax``, ``run_starts``, ``segment_weighted_mode``,
``compact_labels``, ``run_sum``), ``graph.contract``, the engine's
'argmax_weighted' combine, ``run_multilevel`` / ``Hierarchy``, label
propagation, modularity and multi-level Louvain, against the live
reference on the same numpy inputs (the port's CPU path takes the
``segment_mode`` kernel's plain version).

Bit-equal: the primitives, ``contract``, ``compact_labels``, LPA in every
mode (and its golden), and Louvain's labels on integer-weighted graphs —
each (destination, label) run is summed in stream order, as the
reference's segment sum runs on the CPU.  Modularity within 1e-6 (its
totals are ``tree_sum``s, the reference's ``jnp.sum``s reduce in another
order); on f32-weighted RMAT-10 Louvain's partition is the reference's and
its Q within 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as RA
from repro.core import graph as RG
from repro.core import offload as RO
from repro.core.algorithms import louvain as RL
from repro_torch.core import algorithms as TA
from repro_torch.core import engine as TE
from repro_torch.core import graph as TG
from repro_torch.core import offload as TO
from repro_torch.core.algorithms import louvain as TL
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

MODES = ("push", "pull", "auto")
GOLD = np.load(os.path.join(os.path.dirname(__file__), "golden",
                            "core_grid.npz"))


def port(g):
    return TG.csr_from_numpy(np.asarray(g.indptr), np.asarray(g.indices),
                             None if g.values is None else
                             np.asarray(g.values), g.n_rows, g.n_cols,
                             device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _stream(seed):
    """A random structured stream: ids with -1 and >= n, labels < 0, -inf
    weights, integer weights (ties) on even seeds, f32 weights spanning six
    orders of magnitude on odd ones, and an empty stream at seed 0."""
    rng = np.random.default_rng(seed)
    # one stream shape, so the reference's eager ops compile once
    m, n = (0 if seed == 0 else 2000), 150
    idx = rng.integers(-2, n + 2, m).astype(np.int32)
    lab = rng.integers(-2, 12, m).astype(np.int32)
    if seed % 2:
        w = (rng.random(m) * 10.0 ** rng.integers(-3, 3, m)).astype(
            np.float32)
    else:
        w = rng.integers(0, 4, m).astype(np.float32)
    w[rng.random(m) < 0.03] = -np.inf
    return idx, lab, w, n


def _same(got, want):
    for a, b in zip(got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# offload primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_segment_weighted_mode_matches_reference(seed):
    idx, lab, w, n = _stream(seed)
    _same(TO.segment_weighted_mode(_t(idx), _t(lab), _t(w), n),
          RO.segment_weighted_mode(jnp.asarray(idx), jnp.asarray(lab),
                                   jnp.asarray(w), n))


@pytest.mark.parametrize("seed", range(1, 3))
def test_segment_argmax_matches_reference(seed):
    idx, lab, w, n = _stream(seed)
    lab = np.abs(lab)                                   # payloads
    _same(TO.segment_argmax(_t(idx), _t(w), _t(lab), n),
          RO.segment_argmax(jnp.asarray(idx), jnp.asarray(w),
                            jnp.asarray(lab), n))


def test_run_starts_and_compact_labels_match_reference():
    rng = np.random.default_rng(3)
    a = np.sort(rng.integers(0, 5, 300))
    b = rng.integers(0, 3, 300)
    order = np.lexsort((b, a))
    a, b = a[order], b[order]
    got = TO.run_starts(_t(a), _t(b))
    want = RO.run_starts(jnp.asarray(a), jnp.asarray(b))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for lab in (rng.integers(0, 40, 500) * 7 - 3,
                np.array([30, 5, 30, 7, 5, 99]), np.zeros(0, np.int64)):
        lab = lab.astype(np.int32)
        dense, n_c = TO.compact_labels(_t(lab))
        r_dense, r_n = RO.compact_labels(jnp.asarray(lab))
        assert dense.dtype == torch.int32 and int(n_c) == int(r_n)
        np.testing.assert_array_equal(dense.numpy(), np.asarray(r_dense))


def test_run_sum_adds_in_stream_order():
    """The plain in-order run sum (torch's CPU index_add_, which adds in
    item order) equals a scalar float32 loop and the reference's segment
    sum."""
    rng = np.random.default_rng(4)
    n = 50
    idx = np.sort(np.r_[np.full(400, 7), rng.integers(-1, n + 1, 2000)])
    w = (rng.random(idx.size) * 10.0 ** rng.integers(-4, 4, idx.size)
         ).astype(np.float32)
    loop = np.zeros(n, np.float32)
    for i, x in zip(idx, w):
        if 0 <= i < n:
            loop[i] = np.float32(loop[i] + x)
    got = TO.run_sum(_t(idx), _t(w), n)
    np.testing.assert_array_equal(got.numpy(), loop)
    keep = (idx >= 0) & (idx < n)
    np.testing.assert_array_equal(loop, np.asarray(
        jax.ops.segment_sum(jnp.asarray(w[keep]), jnp.asarray(idx[keep]),
                            num_segments=n)))
    # any order of ids: a stable sort, then the in-order run sum
    ir, wr = idx[::-1].copy(), w[::-1].copy()
    kr = (ir >= 0) & (ir < n)
    np.testing.assert_array_equal(
        TO.segment_sum_ordered(_t(wr), _t(ir), n).numpy(),
        np.asarray(jax.ops.segment_sum(jnp.asarray(wr[kr]),
                                       jnp.asarray(ir[kr]),
                                       num_segments=n)))


def test_tree_sum_fixed_order():
    rng = np.random.default_rng(5)
    for size in (0, 1, 2, 3, 1000, 1025):
        x = (rng.random(size) * 10.0 ** rng.integers(-3, 3, size)).astype(
            np.float32)
        got = TO.tree_sum(_t(x))
        assert got.dim() == 0 and got.dtype == torch.float32
        assert abs(float(got) - float(x.astype(np.float64).sum())) <= \
            1e-6 * max(1.0, float(np.abs(x).sum()))


# ---------------------------------------------------------------------------
# contraction, hierarchy, the multilevel pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [True, False])
def test_contract_byte_equal(weighted):
    g = RG.rmat(8, 6, seed=5, weighted=weighted)
    labels = np.random.default_rng(6).integers(0, 30, g.n_rows) * 7 + 3
    rc, rd = RG.contract(g, labels)
    tc, td = port(g).contract(_t(labels))
    assert (tc.n_rows, tc.n_cols) == (rc.n_rows, rc.n_cols)
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    for f in ("indptr", "indices", "values"):
        a, b = getattr(tc, f).numpy(), np.asarray(getattr(rc, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


def test_contract_self_loops_and_empty():
    rows, cols = [], []
    for c in range(2):
        for i in range(3):
            for j in range(3):
                if i != j:
                    rows.append(c * 3 + i)
                    cols.append(c * 3 + j)
    g = TG.CSR.from_coo(rows + [0], cols + [3], np.ones(13, np.float32), 6,
                        6, device="cpu")
    coarse, renumber = TG.contract(g, _t([5, 5, 5, 9, 9, 9]))
    np.testing.assert_array_equal(coarse.to_dense().numpy(),
                                  [[6.0, 1.0], [0.0, 6.0]])
    np.testing.assert_array_equal(renumber.numpy(), [0, 0, 0, 1, 1, 1])
    empty = TG.CSR.from_coo([], [], None, 4, 4, device="cpu")
    c, r = TG.contract(empty, _t([3, 1, 3, 0]))
    assert c.n_rows == 3 and c.nnz == 0 and r.tolist() == [2, 1, 2, 0]
    with pytest.raises(ValueError, match="labels"):
        TG.contract(empty, _t([0, 1]))


def test_hierarchy_projects_through_levels():
    hier = TE.Hierarchy((_t([0, 0, 1, 1, 2]), _t([0, 1, 1])))
    assert hier.n_levels == 2
    np.testing.assert_array_equal(hier.project(_t([10, 20])).numpy(),
                                  [10, 10, 20, 20, 20])


def test_run_multilevel_acceptance_rule():
    """Zero accepted levels for an identity assignment (one level_fn call,
    no contraction); a stalling second level is discarded without its
    contraction; scores increase strictly."""
    g = port(RG.uniform_random_graph(80, 4, seed=2))
    calls, contracted = [], []

    def identity(gl, level):
        calls.append(level)
        return torch.arange(gl.n_rows, dtype=torch.int32)

    labels, hier, scores = TE.run_multilevel(g, identity, TG.contract,
                                             TL.modularity, max_levels=5)
    assert scores == [] and hier.n_levels == 0 and calls == [0]
    np.testing.assert_array_equal(labels.numpy(), np.arange(80))

    def once(gl, level):
        if level == 0:
            return TL.louvain_local_moves(gl)[0]
        return torch.arange(gl.n_rows, dtype=torch.int32)

    def counting(gl, assign):
        contracted.append(gl.n_rows)
        return TG.contract(gl, assign)

    labels, hier, scores = TE.run_multilevel(g, once, counting,
                                             TL.modularity, max_levels=5)
    assert len(scores) == 1 and hier.n_levels == 1 and contracted == [80]
    assert abs(float(TL.modularity(g, labels)) - scores[0]) < 1e-6


# ---------------------------------------------------------------------------
# engine: the structured combine's contract
# ---------------------------------------------------------------------------

def test_structured_program_errors():
    noop = dict(msg_fn=None, update_fn=None)
    with pytest.raises(ValueError, match="edge_op must be 'mul'"):
        TE.VertexProgram(edge_op="add", combine="argmax_weighted", **noop)
    with pytest.raises(ValueError, match="argmax_weighted"):
        TE.VertexProgram(edge_op="mul", combine="mode", **noop)
    prog = TA.lpa_program()
    assert prog.structured and prog.ident == float("-inf")
    g = port(RG.rmat(6, 4, seed=1))
    n = g.n_rows
    state0 = {"label": torch.arange(n, dtype=torch.int32)}
    ones = torch.ones(n, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="lane-batched"):
        TE.run_batched(g, prog, state0, ones, max_iters=1)
    bb = TE.build_pull_operand(g, block_rows=32, block_cols=32, tile_nnz=64)
    with pytest.raises(ValueError, match="no kernel path"):
        TE.run(g, prog, state0, ones, max_iters=1, kernel_bb=bb)
    sample = TE.VertexProgram(edge_op="copy", combine="sample", **noop)
    with pytest.raises(ValueError, match="key="):
        TE.run(g, sample, state0, ones, max_iters=1)


# ---------------------------------------------------------------------------
# label propagation, modularity, Louvain
# ---------------------------------------------------------------------------

GRAPHS = {"w10": RG.rmat(10, 8, seed=3),
          "u10": RG.rmat(10, 8, seed=3, weighted=False),
          "u8": RG.rmat(8, 8, seed=5, weighted=False)}
LPA_CASES = [("w10", m) for m in MODES] + [("u8", m) for m in MODES] + \
    [("u10", "pull")]


@pytest.fixture(scope="module")
def lpa_reference():
    return {(name, mode): np.asarray(RA.label_propagation(
        GRAPHS[name], iters=5, mode=mode)) for name, mode in LPA_CASES}


@pytest.mark.parametrize("name,mode", LPA_CASES)
def test_label_propagation_bit_equal(lpa_reference, name, mode):
    got = TA.label_propagation(port(GRAPHS[name]), iters=5, mode=mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), lpa_reference[name, mode])


def test_lpa_golden():
    g = port(RG.rmat(7, 8, seed=11))
    np.testing.assert_array_equal(TA.label_propagation(g, iters=4).numpy(),
                                  GOLD["lpa/scalar/auto"])


@pytest.mark.parametrize("name", ["w10", "u10"])
def test_modularity_within_1e6(lpa_reference, name):
    g, t = GRAPHS[name], port(GRAPHS[name])
    for lab in (lpa_reference[name, "pull"], np.arange(g.n_rows),
                np.random.default_rng(1).integers(0, 9, g.n_rows)):
        lab = lab.astype(np.int32)
        got = TA.modularity(t, _t(lab))
        assert got.dim() == 0
        assert abs(float(got) - float(RA.modularity(g, jnp.asarray(lab)))) \
            <= 1e-6


def _two_cliques():
    rows, cols = [], []
    for c in range(2):
        for i in range(8):
            for j in range(8):
                if i != j:
                    rows.append(c * 8 + i)
                    cols.append(c * 8 + j)
    return np.array(rows + [0, 8]), np.array(cols + [8, 0])


@pytest.fixture(scope="module")
def louvain_reference():
    r, c = _two_cliques()
    cliques = RG.CSR.from_coo(r, c, np.ones(r.size, np.float32), 16, 16)
    u10, w10 = GRAPHS["u10"], GRAPHS["w10"]
    return {"u10_local": RL.louvain_local_moves(u10),
            "u10": RL.multilevel(u10),
            "cliques": RL.multilevel(cliques),
            "w10": RL.multilevel(w10)}


def test_louvain_local_moves_bit_equal(louvain_reference):
    r_lab, r_q = louvain_reference["u10_local"]
    lab, q = TL.louvain_local_moves(port(GRAPHS["u10"]))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(r_lab))
    assert abs(q - r_q) <= 1e-6


@pytest.mark.parametrize("name", ["u10", "cliques"])
def test_multilevel_bit_equal_on_integer_weights(louvain_reference, name):
    if name == "cliques":
        r, c = _two_cliques()
        g = TG.CSR.from_coo(r, c, np.ones(r.size, np.float32), 16, 16,
                            device="cpu")
    else:
        g = port(GRAPHS[name])
    r_lab, r_scores = louvain_reference[name]
    lab, scores = TA.multilevel(g)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(r_lab))
    assert len(scores) == len(r_scores) >= 1
    np.testing.assert_allclose(scores, r_scores, rtol=0, atol=1e-6)
    assert all(b > a for a, b in zip(scores, scores[1:]))
    assert abs(float(TA.modularity(g, lab)) - scores[-1]) <= 1e-6
    if name == "cliques":
        assert len(set(lab[:8].tolist())) == 1 != len(set(lab.tolist()))


def test_multilevel_f32_weights_same_partition(louvain_reference):
    r_lab, r_scores = louvain_reference["w10"]
    t = port(GRAPHS["w10"])
    lab, scores = TA.multilevel(t)
    assert TA.partition_equal(lab, np.asarray(r_lab))
    assert abs(scores[-1] - r_scores[-1]) <= 1e-5
    # Q is invariant under contraction, and beats a single LPA sweep
    coarse, renumber = TG.contract(t, lab)
    q_coarse = TA.modularity(coarse, torch.arange(coarse.n_rows,
                                                  dtype=torch.int32))
    assert abs(float(q_coarse) - scores[-1]) <= 1e-5
    q_sweep = float(TA.modularity(t, TA.label_propagation(t, iters=1)))
    assert scores[-1] > 5 * abs(q_sweep)


def test_partition_equal():
    assert TA.partition_equal([0, 0, 1], torch.tensor([5, 5, 2]))
    assert not TA.partition_equal([0, 0, 1], [5, 2, 2])
    assert not TA.partition_equal([0, 1, 1], [5, 5, 5])
