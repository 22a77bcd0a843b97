"""Port parity for the batched lanes: ``repro_torch``'s ``run_batched``
(bit-packed 'or' lanes and vmapped valued lanes), ``msbfs``,
``sssp_batched``, ``ppr_batched`` / ``ppr_topk``, the lane packing and
``segment_or`` against the live reference, on the same numpy inputs (the
port's CPU path takes the kernels' plain versions; the reference runs its
Pallas kernels in interpret mode).

MS-BFS and batched SSSP exact, with iters / pushes / pulls and the
per-level trace rows equal; PPR within rtol 1e-5 / atol 1e-6 (f32 sums in
another order), held to the reference's live ``ppr_batched`` (not to a
per-source loop, which the reference itself does not meet).  Lane words
are int32 in the port: they equal the reference's uint32 words viewed as
int32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as RA
from repro.core import engine as RE
from repro.core import graph as RG
from repro.core import offload as RO
from repro.core.algorithms.pagerank import ppr_program as r_ppr_program
from repro.obs import decode_level_trace as r_decode
from repro_torch.core import algorithms as TA
from repro_torch.core import engine as TE
from repro_torch.core import graph as TG
from repro_torch.core import offload as TO
from repro_torch.kernels import _build
from repro_torch.kernels import segment_or as TSO
from repro_torch.obs import decode_level_trace as t_decode

MODES = ("push", "pull", "auto")
GEO = dict(block_rows=32, block_cols=32, tile_nnz=64)
RTOL, ATOL = 1e-5, 1e-6
G = RG.rmat(7, 8, seed=11)
U = RG.uniform_random_graph(150, 4, seed=5)
# 33 lanes (past one word), vertices 0 and 4 twice
SOURCES = np.r_[np.arange(31) * 4, 0, 4].astype(np.int32)
DELTA = 0.3


def port(g):
    return TG.csr_from_numpy(np.asarray(g.indptr), np.asarray(g.indices),
                             None if g.values is None else
                             np.asarray(g.values), g.n_rows, g.n_cols,
                             device="cpu")


T = {"rmat": (G, port(G)), "uniform": (U, port(U))}


def _stats(s):
    return {k: int(s[k]) for k in ("iters", "pushes", "pulls")}


def _same_stats_and_trace(tstats, rstats):
    assert {k: tstats[k] for k in ("iters", "pushes", "pulls")} == \
        _stats(rstats)
    np.testing.assert_array_equal(tstats["trace"].numpy(),
                                  np.asarray(rstats["trace"]))
    assert [r.as_dict() for r in t_decode(tstats)] == \
        [r.as_dict() for r in r_decode(rstats)]


@pytest.mark.parametrize("B", [1, 31, 32, 33, 70])
def test_lane_words_match_reference(B):
    rng = np.random.default_rng(B)
    bits = (rng.random((B, 57)) < 0.4).astype(np.int32)
    bits[:, 0] = 1                                   # every lane, bit 31 too
    want = np.asarray(RE.pack_lanes(jnp.asarray(bits))).view(np.int32)
    words = TE.pack_lanes(torch.from_numpy(bits))
    assert words.dtype == torch.int32
    assert words.shape == (57, TE.lane_words(B)) == want.shape
    np.testing.assert_array_equal(words.numpy(), want)
    np.testing.assert_array_equal(TE.unpack_lanes(words, B).numpy(), bits)
    np.testing.assert_array_equal(
        TE.unpack_lanes(words, B).numpy(),
        np.asarray(RE.unpack_lanes(jnp.asarray(want.view(np.uint32)), B)))


@pytest.mark.parametrize("presorted", [False, True])
def test_segment_or_matches_reference(presorted):
    rng = np.random.default_rng(2)
    n, m, W = 40, 300, 3
    idx = rng.integers(-2, n + 2, m).astype(np.int32)   # out of range too
    if presorted:
        idx = np.sort(idx)
    words = rng.integers(0, 2 ** 32, (m, W), dtype=np.uint64).astype(
        np.uint32)
    words[::7] = 0xFFFFFFFF                              # all 32 bits
    # jitted as the reference's engine calls it (eager, its scan dispatches
    # op by op and takes some 10 s on the CPU)
    ref_or = jax.jit(RO.segment_or, static_argnums=2,
                     static_argnames="presorted")
    want = np.asarray(ref_or(jnp.asarray(idx), jnp.asarray(words), n,
                             presorted=presorted)).view(np.int32)
    got = TO.segment_or(torch.from_numpy(idx),
                        torch.from_numpy(words.view(np.int32)), n,
                        presorted=presorted)
    assert got.dtype == torch.int32 and got.shape == (n, W)
    np.testing.assert_array_equal(got.numpy(), want)
    empty = TO.segment_or(torch.zeros(0, dtype=torch.int32),
                          torch.zeros((0, 2), dtype=torch.int32), 5)
    assert empty.shape == (5, 2) and not bool(empty.any())


@pytest.mark.parametrize("graph,mode", [("rmat", m) for m in MODES]
                         + [("uniform", "auto")])
def test_msbfs_matches_reference(graph, mode):
    g, t = T[graph]
    lv, rstats = RA.msbfs(g, SOURCES, mode=mode, return_stats=True,
                          trace=True)
    tl, tstats = TA.msbfs(t, SOURCES, mode=mode, return_stats=True,
                          trace=True)
    assert tl.dtype == torch.int32 and tl.shape == (len(SOURCES), g.n_rows)
    assert tl.is_contiguous()        # a lane's row reads back in one run
    np.testing.assert_array_equal(tl.numpy(), np.asarray(lv))
    _same_stats_and_trace(tstats, rstats)
    for b in (0, 31, 32):
        assert torch.equal(tl[b], TA.bfs(t, int(SOURCES[b]), mode=mode))


def test_msbfs_single_lane_matches_reference():
    g, t = T["rmat"]
    np.testing.assert_array_equal(TA.msbfs(t, [5]).numpy(),
                                  np.asarray(RA.msbfs(g, np.array([5]))))


@pytest.mark.parametrize("mode,kernel", [(m, False) for m in MODES]
                         + [("push", True), ("pull", True)])
def test_sssp_batched_matches_reference(mode, kernel):
    """Bit-equal distances, stats and trace; the kernel operand takes the
    (min,+) SpMSpV per lane on the union frontier's tiles (push) or on
    every tile (pull)."""
    g, t = T["rmat"]
    src = SOURCES[:8]
    rbb = RE.build_pull_operand(g, combine="min", **GEO) if kernel else None
    tbb = TE.build_pull_operand(t, combine="min", **GEO) if kernel else None
    rd, rstats = RA.sssp_batched(g, src, delta=DELTA, mode=mode,
                                 kernel_bb=rbb, return_stats=True,
                                 trace=True, trace_len=8)
    td, tstats = TA.sssp_batched(t, src, delta=DELTA, mode=mode,
                                 kernel_bb=tbb, return_stats=True,
                                 trace=True, trace_len=8)
    assert td.numpy().tobytes() == np.asarray(rd).tobytes()
    _same_stats_and_trace(tstats, rstats)
    for b in (0, 7):
        assert torch.equal(td[b], TA.sssp(t, int(src[b]), delta=DELTA,
                                          mode=mode))


@pytest.mark.parametrize("kernel", [False, True])
def test_ppr_batched_matches_reference(kernel):
    """ppr_batched, and run_batched on ppr_program over the unit operand
    (one B2 launch per lane per level), against the reference's live
    ppr_batched."""
    g, t = T["uniform"]
    n, src = g.n_rows, SOURCES[:6]
    want, rstats = RA.ppr_batched(g, src, iters=12, return_stats=True,
                                  trace=True)
    if kernel:
        r = torch.zeros((len(src), n))
        r[torch.arange(len(src)), torch.from_numpy(src).long()] = 1.0
        st, tstats = TE.run_batched(
            t, TA.ppr_program(t, 0.85), {"x": r, "r": r},
            torch.ones((len(src), n), dtype=torch.int32), max_iters=12,
            mode="pull", return_stats=True, trace=True,
            kernel_bb=TE.build_pull_operand(t, unit_values=True, **GEO))
        got = st["x"]
    else:
        got, tstats = TA.ppr_batched(t, src, iters=12, return_stats=True,
                                     trace=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    _same_stats_and_trace(tstats, rstats)


def test_run_batched_valued_push_matches_reference():
    """A valued 'add' program through run_batched's sparse step, which
    gathers the rows of the union frontier's vertices for every lane:
    PPR's program on a random 5% frontier per lane, pushed."""
    g, t = T["rmat"]
    n, B = g.n_rows, 5
    rng = np.random.default_rng(4)
    x0 = rng.random((B, n)).astype(np.float32)
    f0 = (rng.random((B, n)) < 0.05).astype(np.int32)
    rs, rstats = RE.run_batched(
        g, r_ppr_program(g, 0.85), {"x": jnp.asarray(x0),
                                    "r": jnp.asarray(x0)},
        jnp.asarray(f0), max_iters=3, mode="push", return_stats=True,
        trace=True)
    ts, tstats = TE.run_batched(
        t, TA.ppr_program(t, 0.85), {"x": torch.from_numpy(x0),
                                     "r": torch.from_numpy(x0)},
        torch.from_numpy(f0), max_iters=3, mode="push", return_stats=True,
        trace=True)
    np.testing.assert_allclose(ts["x"].numpy(), np.asarray(rs["x"]),
                               rtol=RTOL, atol=ATOL)
    _same_stats_and_trace(tstats, rstats)


def test_ppr_topk_matches_reference():
    g, t = T["uniform"]
    src, k = SOURCES[:6], 5
    rv, ri = RA.ppr_topk(g, src, k, iters=12)
    tv, ti = TA.ppr_topk(t, src, k, iters=12)
    assert tv.shape == ti.shape == (len(src), k) and ti.dtype == torch.int32
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=RTOL,
                               atol=ATOL)
    # ids are equal wherever a score stands apart from its neighbours
    x = -np.sort(-np.asarray(RA.ppr_batched(g, src, iters=12)), 1)
    left = np.c_[np.full(len(src), np.inf), x[:, :k - 1] - x[:, 1:k]]
    right = x[:, :k] - x[:, 1:k + 1]
    clear = (left > 1e-5) & (right > 1e-5)
    assert clear.any()
    np.testing.assert_array_equal(ti.numpy()[clear], np.asarray(ri)[clear])


def test_batched_error_paths():
    _, t = T["rmat"]
    n = t.n_rows
    noop = dict(msg_fn=None, update_fn=None)
    with pytest.raises(ValueError, match="copy"):
        TE.VertexProgram(edge_op="mul", combine="or", **noop)
    with pytest.raises(ValueError):                # structured: not taken
        TE.VertexProgram(edge_op="copy", combine="sample", **noop)
    prog = TA.msbfs_program(2)
    f0 = TE.pack_lanes(torch.eye(2, n, dtype=torch.int32))
    state0 = {"seen": f0, "level": torch.zeros((2, n), dtype=torch.int32)}
    with pytest.raises(ValueError, match="run_batched"):
        TE.run(t, prog, state0, f0, max_iters=n)
    unit = TE.build_pull_operand(t, unit_values=True, **GEO)
    with pytest.raises(ValueError, match="no kernel combine"):
        TE.run_batched(t, prog, state0, f0, max_iters=n, kernel_bb=unit)
    with pytest.raises(ValueError, match="trace_len"):
        TA.msbfs(t, [0, 1], trace_len=4)
    with pytest.raises(ValueError, match="return_stats"):
        TA.msbfs(t, [0, 1], trace=True)


def test_segment_or_cuda_path_raises_without_a_card(monkeypatch):
    """Operands the wrapper takes for CUDA ones go to the kernel, which
    cannot be built or launched here: it raises, and counts no launch."""
    monkeypatch.setattr(_build, "on_cpu", lambda tensors, what: False)
    before = dict(TSO.LAUNCHES)
    with pytest.raises((RuntimeError, ValueError)):
        TO.segment_or(torch.tensor([0, 1], dtype=torch.int32),
                      torch.ones((2, 1), dtype=torch.int32), 2)
    assert TSO.LAUNCHES == before
