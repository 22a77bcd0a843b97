"""Port parity: the engine and the graph algorithms of ``repro_torch``
against the live reference, in every mode, with and without a BBCSR kernel
operand (the port's CPU path takes the kernels' plain versions; the
reference runs its Pallas kernels in interpret mode).

BFS, SSSP and CC exact; PageRank, PPR and SpMV within rtol 1e-5 / atol 1e-6
(f32 sums in another order).  iters / pushes / pulls equal the
reference's, and so do the per-level trace rows.  Also replays the scalar
entries of ``golden/core_grid.npz``, and checks that a kernel operand's
unit-value check reads the operand once.
"""
import gc
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as RE
from repro.core import graph as RG
from repro.core import algorithms as RA
from repro_torch.core import engine as TE
from repro_torch.core import graph as TG
from repro_torch.core import algorithms as TA
from repro.core.algorithms.bfs import _levels_from_dist as r_levels
from repro.core.algorithms.pagerank import ppr_program as r_ppr_program
from repro.obs import decode_level_trace as r_decode
from repro_torch.obs import decode_level_trace as t_decode
from repro_torch.core.algorithms.bfs import _levels_from_dist as t_levels

GOLD = np.load(os.path.join(os.path.dirname(__file__), "golden",
                            "core_grid.npz"))
MODES = ("push", "pull", "auto")
GEO = dict(block_rows=32, block_cols=32, tile_nnz=64)
G = RG.rmat(7, 8, seed=11)
U = RG.uniform_random_graph(150, 4, seed=5)
DELTA = float(GOLD["meta_delta_g"])
RTOL, ATOL = 1e-5, 1e-6


def port(g):
    return TG.csr_from_numpy(np.asarray(g.indptr), np.asarray(g.indices),
                             None if g.values is None else
                             np.asarray(g.values), g.n_rows, g.n_cols,
                             device="cpu")


TG_G, TG_U = port(G), port(U)


def _stats(s):
    return {k: int(s[k]) for k in ("iters", "pushes", "pulls")}


def _onehot(n, src, dtype=np.int32):
    a = np.zeros(n, dtype)
    a[src] = 1
    return a


def _run_both(g, t, rprog, tprog, state0, frontier0, *, mode, kernel=None,
              max_iters=None):
    """One program through both engines from the same numpy state."""
    n = g.n_rows
    max_iters = max_iters or 4 * n
    rbb = tbb = None
    if kernel is not None:
        rbb = RE.build_pull_operand(g, **kernel, **GEO)
        tbb = TE.build_pull_operand(t, **kernel, **GEO)
    rs, rstats = RE.run(g, rprog, {k: jnp.asarray(v) for k, v in
                                   state0.items()}, jnp.asarray(frontier0),
                        max_iters=max_iters, mode=mode, kernel_bb=rbb,
                        return_stats=True)
    ts, tstats = TE.run(t, tprog, {k: torch.as_tensor(v) for k, v in
                                   state0.items()}, torch.as_tensor(frontier0),
                        max_iters=max_iters, mode=mode, kernel_bb=tbb,
                        return_stats=True)
    assert tstats == _stats(rstats)
    return ({k: np.asarray(v) for k, v in rs.items()},
            {k: v.numpy() for k, v in ts.items()})


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_bfs_matches_reference(mode, kernel):
    n = G.n_rows
    level0 = np.full(n, -1, np.int32)
    level0[0] = 0
    r, t = _run_both(G, TG_G, RA.bfs_program(), TA.bfs_program(),
                     {"level": level0}, _onehot(n, 0), mode=mode,
                     kernel=dict(unit_values=True) if kernel else None)
    np.testing.assert_array_equal(t["level"], r["level"])
    bb = TE.build_pull_operand(TG_G, unit_values=True, **GEO) \
        if kernel else None
    np.testing.assert_array_equal(TA.bfs(TG_G, 0, mode=mode,
                                         kernel_bb=bb).numpy(), r["level"])


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_sssp_matches_reference(mode, kernel):
    n = G.n_rows
    dist0 = np.full(n, np.inf, np.float32)
    dist0[0] = 0.0
    state0 = {"dist": dist0, "pending": _onehot(n, 0, bool),
              "bound": np.float32(DELTA)}
    r, t = _run_both(G, TG_G, RA.sssp_program(DELTA), TA.sssp_program(DELTA),
                     state0, _onehot(n, 0), mode=mode,
                     kernel=dict(combine="min") if kernel else None)
    assert t["dist"].tobytes() == r["dist"].tobytes()
    d, stats = TA.sssp(TG_G, 0, delta=DELTA, mode=mode, return_stats=True)
    rd, rstats = RA.sssp(G, 0, delta=DELTA, mode=mode, return_stats=True)
    assert d.numpy().tobytes() == np.asarray(rd).tobytes()
    assert stats == _stats(rstats)


@pytest.mark.parametrize("mode", MODES)
def test_cc_and_level_bfs_match_reference(mode):
    labels, stats = TA.connected_components(TG_U, mode=mode,
                                            return_stats=True)
    rl, rstats = RA.connected_components(U, mode=mode, return_stats=True)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(rl))
    assert stats == _stats(rstats)
    n = G.n_rows
    dist0 = np.full(n, np.inf, np.float32)
    dist0[5] = 0.0
    r, t = _run_both(G, TG_G, RA.bfs_level_program(),
                     TA.bfs_level_program(), {"dist": dist0}, _onehot(n, 5),
                     mode=mode)
    np.testing.assert_array_equal(
        t_levels(torch.from_numpy(t["dist"])).numpy(),
        np.asarray(r_levels(jnp.asarray(r["dist"]))))


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_pagerank_program_matches_reference(mode, kernel):
    """PageRank's update is ppr_program's with a uniform restart vector;
    driven through both engines in every mode, on the unit kernel operand
    or not."""
    n = G.n_rows
    r0 = np.full(n, 1.0 / n, np.float32)
    r, t = _run_both(G, TG_G, r_ppr_program(G, 0.85),
                     TA.ppr_program(TG_G, 0.85), {"x": r0, "r": r0},
                     np.ones(n, np.int32), mode=mode, max_iters=20,
                     kernel=dict(unit_values=True) if kernel else None)
    np.testing.assert_allclose(t["x"], r["x"], rtol=RTOL, atol=ATOL)


def test_pagerank_ppr_spmv_match_reference():
    np.testing.assert_allclose(TA.pagerank(TG_G).numpy(),
                               np.asarray(RA.pagerank(G)), rtol=RTOL,
                               atol=ATOL)
    assert abs(float(TA.pagerank(TG_G).double().sum()) - 1.0) < 1e-5
    np.testing.assert_allclose(TA.ppr(TG_G, 3, iters=12).numpy(),
                               np.asarray(RA.ppr(G, 3, iters=12)),
                               rtol=RTOL, atol=ATOL)
    x = np.random.default_rng(0).random(G.n_cols).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    want = np.asarray(RA.spmv(G, jx))
    np.testing.assert_allclose(TA.spmv(TG_G, tx).numpy(), want, rtol=RTOL,
                               atol=ATOL)
    ell, tell = RG.to_padded_ell(G), TG.to_padded_ell(TG_G)
    np.testing.assert_allclose(TA.spmv_ell(*tell, tx).numpy(),
                               np.asarray(RA.spmv_ell(*ell, jx)), rtol=RTOL,
                               atol=ATOL)
    bb = RG.to_bbcsr(G, **GEO)
    np.testing.assert_allclose(
        TA.spmv_bbcsr(TG.to_bbcsr(TG_G, **GEO), tx).numpy(),
        np.asarray(RA.spmv_bbcsr(bb, jx)), rtol=RTOL, atol=ATOL)
    ids = np.array([3, -1, 7, 7, 100], np.int32)
    v = np.array([1.0, 0.0, 2.0, 0.5, 3.0], np.float32)
    for k in (None, 3):
        np.testing.assert_allclose(
            TA.spmspv(TG_G, torch.from_numpy(ids), torch.from_numpy(v),
                      max_deg=k).numpy(),
            np.asarray(RA.spmspv(G, jnp.asarray(ids), jnp.asarray(v),
                                 max_deg=k)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        TA.spmspv_ell(*tell, G.n_cols, torch.from_numpy(ids),
                      torch.from_numpy(v)).numpy(),
        np.asarray(RA.spmspv_ell(*ell, G.n_cols, jnp.asarray(ids),
                                 jnp.asarray(v))), rtol=RTOL, atol=ATOL)


def test_auto_delta_matches_unscaled_reference():
    # the port keeps no tuned-parameter file: its delta_scale is the
    # default 1.0, the reference's raw histogram quantile
    want = RA.auto_delta(G, scaled=False)
    assert TA.auto_delta(TG_G, scaled=False) == want
    assert TA.auto_delta(TG_G) == want
    assert TA.auto_delta(port(RG.rmat(6, 4, seed=1, weighted=False))) == 1.0


def test_engine_rejects_bad_programs_and_operands():
    noop = dict(msg_fn=None, update_fn=None)
    with pytest.raises(ValueError):
        TE.VertexProgram(edge_op="div", combine="add", **noop)
    with pytest.raises(ValueError):
        TE.VertexProgram(edge_op="mul", combine="median", **noop)
    t = port(U)
    with pytest.raises(ValueError):
        TA.bfs(t, 0, mode="psuh")
    weighted = TE.build_pull_operand(t, **GEO)
    with pytest.raises(ValueError):
        TA.bfs(t, 0, kernel_bb=weighted)        # copy program, weighted op
    n = t.n_rows
    with pytest.raises(ValueError):             # min combine over 'copy'
        TE.run(t, TA.cc_program(), {"label": torch.arange(n,
                                                          dtype=torch.int32)},
               torch.ones(n, dtype=torch.int32), max_iters=n,
               kernel_bb=weighted)


def test_push_capacity_overflow_falls_back_to_dense():
    g = RG.uniform_random_graph(200, 4, seed=1)
    n = g.n_rows
    level0 = np.full(n, -1, np.int32)
    level0[0] = 0
    rs, rstats = RE.run(g, RA.bfs_program(), {"level": jnp.asarray(level0)},
                        jnp.asarray(_onehot(n, 0)), max_iters=n, mode="push",
                        push_capacity=4, return_stats=True)
    ts, tstats = TE.run(port(g), TA.bfs_program(),
                        {"level": torch.from_numpy(level0)},
                        torch.from_numpy(_onehot(n, 0)), max_iters=n,
                        mode="push", push_capacity=4, return_stats=True)
    np.testing.assert_array_equal(ts["level"].numpy(),
                                  np.asarray(rs["level"]))
    assert tstats == _stats(rstats) and tstats["pulls"] > 0


@pytest.mark.parametrize("mode", MODES)
def test_scalar_golden_replay(mode):
    np.testing.assert_array_equal(TA.bfs(TG_G, 0, mode=mode).numpy(),
                                  GOLD[f"bfs/scalar/{mode}"])
    np.testing.assert_array_equal(
        TA.sssp(TG_G, 0, delta=DELTA, mode=mode).numpy(),
        GOLD[f"sssp/scalar/{mode}"])
    np.testing.assert_array_equal(
        TA.connected_components(TG_U, mode=mode).numpy(),
        GOLD[f"cc/scalar/{mode}"])
    np.testing.assert_allclose(TA.ppr(TG_G, 3, iters=12).numpy(),
                               GOLD["ppr/scalar/pull"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("trace_len", [None, 4])
def test_run_trace_matches_reference(trace_len):
    """One [frontier, was_push, 0, 0] row per level, rows past trace_len
    dropped, the same state as an untraced run."""
    n = G.n_rows
    dist0 = np.full(n, np.inf, np.float32)
    dist0[0] = 0.0
    state0 = {"dist": dist0, "pending": _onehot(n, 0, bool),
              "bound": np.float32(DELTA)}
    rs, rstats = RE.run(G, RA.sssp_program(DELTA),
                        {k: jnp.asarray(v) for k, v in state0.items()},
                        jnp.asarray(_onehot(n, 0)), max_iters=4 * n,
                        return_stats=True, trace=True, trace_len=trace_len)
    ts, tstats = TE.run(TG_G, TA.sssp_program(DELTA),
                        {k: torch.as_tensor(v) for k, v in state0.items()},
                        torch.as_tensor(_onehot(n, 0)), max_iters=4 * n,
                        return_stats=True, trace=True, trace_len=trace_len)
    assert tstats["trace"].dtype == torch.int32
    np.testing.assert_array_equal(tstats["trace"].numpy(),
                                  np.asarray(rstats["trace"]))
    assert [r.as_dict() for r in t_decode(tstats)] == \
        [r.as_dict() for r in r_decode(rstats)]
    plain = TA.sssp(TG_G, 0, delta=DELTA)
    assert ts["dist"].numpy().tobytes() == plain.numpy().tobytes()
    with pytest.raises(ValueError):
        TE.run(TG_G, TA.sssp_program(DELTA), state0, torch.ones(n),
               max_iters=1, trace=True)            # trace needs the stats


def test_unit_value_check_reads_each_operand_once(monkeypatch):
    """The unit-value check of a 'copy' program's kernel operand reads the
    operand's values on its first run only, and a weighted operand is
    refused every time."""
    calls = []
    real = TE._unit_valued
    monkeypatch.setattr(TE, "_unit_valued",
                        lambda vals: calls.append(1) or real(vals))
    unit = TE.build_pull_operand(TG_G, unit_values=True, **GEO)
    first = TA.bfs(TG_G, 0, kernel_bb=unit)
    assert torch.equal(TA.bfs(TG_G, 0, kernel_bb=unit), first)
    assert len(calls) == 1
    weighted = TE.build_pull_operand(TG_G, **GEO)
    for _ in range(2):
        with pytest.raises(ValueError, match="unit-valued"):
            TA.bfs(TG_G, 0, kernel_bb=weighted)
    assert len(calls) == 2
    key = id(unit)
    del unit
    gc.collect()
    assert key not in TE._UNIT_OPERANDS
