"""Port parity for the serving surface: ``repro_torch``'s ``GraphHandle``
and ``GraphService`` against the live reference, on the same numpy inputs.

* ``GraphHandle`` on ``rmat(7, 8, seed=11)`` (weighted and unweighted): a
  seeded stream of ``apply`` batches (inserts, deletes, upserts, duplicate
  inserts, a batch that trips compaction), then ``replace`` and
  ``compact``; after every step the CSR arrays, the epoch, the stamps, the
  delta log and every ``UpdateReport`` field are byte-equal.
* ``GraphService`` on a two-blob graph at ``batch_budget=4``: one seeded
  mixed stream of all four kinds with repeated queries, duplicate sources,
  deadlines on a ticking fake clock, ``poll``, one ``apply_updates``
  confined to a partition and the deprecated ``update_graph``.  Flushed
  tickets, reachability and distance answers (bit-equal), PPR (ids where
  the scores are clear of ties, scores within rtol 1e-5 / atol 1e-6: f32
  sums in another order), ``stats.as_dict()``, the cache's keys, the spans
  and the decoded level runs all equal the reference's.  The port's
  ``sssp.delta_scale`` and engine knobs are set to the values the
  reference resolves from its tuned file (the port's own default
  delta_scale differs by design, ROADMAP §C.3).
* ``NeighborSample`` by distribution (the reference's threefry keys cannot
  be replayed): real out-neighbours, sinks stay put, draws independent of
  the batch around them, cache reuse across an epoch that leaves the
  partition alone, a new draw after it is mutated, chi-square uniformity on
  a hub, and the keyed hash against a numpy splitmix64.
* Error paths and ``load_cost_priors`` equal to the reference's.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import tune as RT
from repro.core import graph as RG
from repro.core import service as RS
from repro.obs import MetricsRegistry as RMetrics
from repro.obs import Observability as RObs
from repro_torch import tune as TT
from repro_torch.core import engine as TE
from repro_torch.core import graph as TG
from repro_torch.core import service as TS
from repro_torch.obs import MetricsRegistry as TMetrics
from repro_torch.obs import Observability as TObs

RTOL, ATOL = 1e-5, 1e-6
G = RG.rmat(7, 8, seed=11)
G_UNW = RG.rmat(7, 8, seed=11, weighted=False)


def port(g):
    return TG.csr_from_numpy(np.asarray(g.indptr), np.asarray(g.indices),
                             None if g.values is None else
                             np.asarray(g.values), g.n_rows, g.n_cols,
                             device="cpu")


def _two_blob_graph(n=256, seed=21):
    """Two disconnected 128-vertex blobs, as the reference's service tests
    build them: queries inside blob B (vertices 128..255, partitions 4..7
    under the default 8-partition block rule) never touch blob A's."""
    half = n // 2
    a = RG.uniform_random_graph(half, 3, seed=seed)
    b = RG.uniform_random_graph(half, 3, seed=seed + 1)

    def coo(g, off):
        indptr = np.asarray(g.indptr)
        rows = np.repeat(np.arange(half), np.diff(indptr)) + off
        return rows, np.asarray(g.indices) + off, np.asarray(g.values)

    ra, ca, va = coo(a, 0)
    rb, cb, vb = coo(b, half)
    return RG.CSR.from_coo(np.concatenate([ra, rb]), np.concatenate([ca, cb]),
                           np.concatenate([va, vb]), n, n)


BLOBS = _two_blob_graph()


def _same(ref, got):
    """Byte-equal arrays (a port tensor or numpy array against the
    reference's array), None against None."""
    if ref is None:
        assert got is None
        return
    a = np.asarray(ref)
    b = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def _same_handle(r, t):
    for f in ("indptr", "indices", "values"):
        _same(getattr(r.csr, f), getattr(t.csr, f))
    assert (r.epoch, r.n_partitions, r.compact_threshold) == \
        (t.epoch, t.n_partitions, t.compact_threshold)
    _same(r.stamps, t.stamps)
    for f in ("ins_rows", "ins_cols", "ins_vals", "del_rows", "del_cols"):
        _same(getattr(r.delta, f), getattr(t.delta, f))
    _same(r.partition_edge_counts(), t.partition_edge_counts())


# ---------------------------------------------------------------------------
# GraphHandle
# ---------------------------------------------------------------------------

def _handle_steps(g, seed=3):
    """The seeded update stream: (label, kind, payload) steps."""
    rng = np.random.default_rng(seed)
    n = g.n_rows
    indptr = np.asarray(g.indptr)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    cols = np.asarray(g.indices)
    ex = rng.choice(rows.size, 40, replace=False)   # existing edges

    def w(k):
        return rng.random(k).astype(np.float32) * 2

    ins_r, ins_c = rng.integers(0, n, 30), rng.integers(0, n, 30)
    dup_r = np.r_[rows[ex[:3]], 5, 5, 5, 7, 7]
    dup_c = np.r_[cols[ex[:3]], 9, 9, 9, 11, 11]
    big = 300                                      # > 0.25 of ~1k edges
    return [
        ("inserts", "apply", ((ins_r, ins_c, w(30)), None)),
        ("deletes, some missing", "apply",
         (None, (np.r_[rows[ex[:10]], 0, 1], np.r_[cols[ex[:10]], 0, 1]))),
        ("upserts", "apply", ((rows[ex[10:20]], cols[ex[10:20]], w(10)),
                              None)),
        ("duplicates, last wins", "apply",
         ((dup_r, dup_c, np.arange(dup_r.size, dtype=np.float32)), None)),
        ("inserts and deletes, default weights", "apply",
         ((rows[ex[20:25]], rng.integers(0, n, 5)),
          (rows[ex[25:30]], cols[ex[25:30]]))),
        ("empty batch", "apply", (None, None)),
        ("compaction", "apply",
         ((rng.integers(0, n, big), rng.integers(0, n, big), w(big)),
          (rows[ex[30:]], cols[ex[30:]]))),
        ("replace", "replace", None),
        ("compact", "compact", None),
    ]


def _run_handle(handle, steps, csr_of):
    out = []
    for _, kind, payload in steps:
        rep = None
        if kind == "apply":
            handle, rep = handle.apply(*payload)
        elif kind == "replace":
            handle = handle.replace(csr_of(RG.rmat(6, 4, seed=5)))
        else:
            handle = handle.compact()
        out.append((handle, rep))
    return out


@pytest.fixture(scope="module", params=["weighted", "unweighted"])
def handle_runs(request):
    g = G if request.param == "weighted" else G_UNW
    steps = _handle_steps(g)
    ref = _run_handle(RG.GraphHandle.wrap(g), steps, lambda c: c)
    got = _run_handle(TG.GraphHandle.wrap(port(g)), steps, port)
    return steps, ref, got


@pytest.mark.parametrize("step", range(9))
def test_handle_stream_matches_reference(handle_runs, step):
    steps, ref, got = handle_runs
    (rh, rrep), (th, trep) = ref[step], got[step]
    _same_handle(rh, th)
    if rrep is None:
        assert trep is None
        return
    for f in dataclasses.fields(rrep):
        a, b = getattr(rrep, f.name), getattr(trep, f.name)
        if isinstance(a, np.ndarray):
            _same(a, b)
        else:
            assert a == b, (steps[step][0], f.name, a, b)


def test_handle_stream_covers_every_case(handle_runs):
    steps, ref, _ = handle_runs
    reps = [r for _, r in ref if r is not None]
    assert any(r.n_upserted for r in reps) and any(r.n_deleted for r in reps)
    assert any(not r.monotone_safe for r in reps)
    assert [r.compacted for r in reps].count(True) == 1


@pytest.mark.parametrize("ins,dels", [
    ((np.array([128]), np.array([0])), None),
    ((np.array([0]), np.array([-1])), None),
    (None, (np.array([-3]), np.array([4]))),
    (None, (np.array([1]), np.array([200]))),
])
def test_handle_rejects_out_of_range_endpoints(ins, dels):
    errs = []
    for handle in (RG.GraphHandle.wrap(G), TG.GraphHandle.wrap(port(G))):
        with pytest.raises(ValueError) as e:
            handle.apply(ins, dels)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("weighted", [True, False])
def test_handle_on_an_empty_graph(weighted):
    """No edges: deletes find nothing, the first inserts (a duplicate
    among them) build the graph, and the log trips compaction."""
    e = np.zeros(0, np.int64)
    g = RG.CSR.from_coo(e, e, np.zeros(0, np.float32) if weighted else None,
                        5, 5)
    ins = (np.array([1, 1, 4]), np.array([2, 2, 0]),
           np.array([1.0, 2.0, 3.0], np.float32))
    dels = (np.array([0]), np.array([0]))
    r, t = RG.GraphHandle.wrap(g), TG.GraphHandle.wrap(port(g))
    _same_handle(r, t)
    for batch in ((None, dels), (ins, dels)):
        (r, rrep), (t, trep) = r.apply(*batch), t.apply(*batch)
        _same_handle(r, t)
        assert (trep.n_inserted, trep.n_deleted, trep.compacted) == \
            (rrep.n_inserted, rrep.n_deleted, rrep.compacted)
    assert trep.n_inserted == 2 and trep.compacted


def test_handle_counts_compactions():
    reg = TG.get_registry()
    before = reg.counter("graph.compactions").value
    h = TG.GraphHandle.wrap(port(G), compact_threshold=0.0)
    h, rep = h.apply((np.array([1]), np.array([2])))
    assert rep.compacted and h.delta.size == 0
    assert reg.counter("graph.compactions").value == before + 1


def test_handle_wrap_canonicalizes_like_the_reference():
    # duplicate (row, col) pairs and unsorted columns: wrap rebuilds
    rows, cols = np.array([0, 0, 2, 0, 1]), np.array([3, 1, 2, 3, 0])
    vals = np.array([1.0, 2.0, 3.0, 0.5, 4.0], np.float32)
    indptr = np.array([0, 3, 4, 5])
    raw = RG.CSR(indptr, cols[[0, 1, 3, 4, 2]], vals[[0, 1, 3, 4, 2]], 3, 4)
    r = RG.GraphHandle.wrap(raw)
    t = TG.GraphHandle.wrap(TG.csr_from_numpy(
        indptr, cols[[0, 1, 3, 4, 2]], vals[[0, 1, 3, 4, 2]], 3, 4,
        device="cpu"))
    _same_handle(r, t)


# ---------------------------------------------------------------------------
# GraphService: the mixed stream against the live reference
# ---------------------------------------------------------------------------

class TickClock:
    """A deterministic clock that advances by a fixed tick on every read,
    so latencies, the cost EWMA and span times are functions of the
    service's clock reads (which the port makes in the reference's
    order), and `advance` models client think time."""

    def __init__(self, tick=1e-3):
        self.t, self.tick = 0.0, tick

    def __call__(self):
        self.t += self.tick
        return self.t

    def advance(self, dt):
        self.t += dt


def _service_ops(n=256, seed=17):
    """One seeded mixed stream: ("q", kind, args, deadline), ("advance",
    dt), ("poll",), ("flush",), ("update", inserts), ("swap",)."""
    rng = np.random.default_rng(seed)
    srcs = np.r_[rng.choice(128, 3, replace=False),
                 128 + rng.choice(128, 4, replace=False)]
    deadlines = [None, None, 0.0, 0.004, 0.05]

    def query():
        kind = ["reach", "dist", "ppr", "sample"][int(rng.integers(4))]
        s = int(rng.choice(srcs))
        blob = 0 if s < 128 else 128
        if kind == "ppr":
            args = (s, int(rng.integers(1, 9)))
        elif kind == "sample":
            args = (blob + int(rng.integers(128)), int(rng.integers(1, 4)),
                    int(rng.integers(2)))
        else:
            args = (s, blob + int(rng.integers(128)))
        return ("q", kind, args,
                deadlines[int(rng.integers(len(deadlines)))])

    first = [query() for _ in range(24)]
    ops = []
    for op in first:
        ops.append(op)
        r = rng.random()
        if r < 0.3:
            ops.append(("advance", float(rng.choice([0.002, 0.01]))))
        elif r < 0.45:
            ops.append(("poll",))
    ops.append(("flush",))
    again = [first[int(i)] for i in rng.choice(len(first), 8, replace=False)]
    ops += [("q",) + op[1:3] + (None,) for op in again]
    ops += [query() for _ in range(4)] + [("flush",)]
    # an edge update confined to partition 0 (vertices 0..31, blob A)
    ops.append(("update", (np.array([3, 5]), np.array([4, 30]),
                           np.array([1e-4, 2.0], np.float32))))
    ops += [("q",) + op[1:3] + (None,) for op in first] + [("flush",)]
    ops.append(("swap",))
    return ops


def _make_query(mod, kind, args):
    return {"reach": mod.Reachability, "dist": mod.Distance,
            "ppr": mod.PPRTopK, "sample": mod.NeighborSample}[kind](*args)


def _key(q):
    return (type(q).__name__,) + dataclasses.astuple(q)


def _run_service(mod, obs_cls, metrics_cls, g):
    clk = TickClock()
    obs = obs_cls(clock=clk, metrics=metrics_cls())
    svc = mod.GraphService(g, batch_budget=4, cache_capacity=64, clock=clk,
                           obs=obs)
    log = {"tickets": [], "results": {}, "queries": {}, "cache": []}
    pending = []
    for op in _service_ops():
        if op[0] == "q":
            q = _make_query(mod, op[1], op[2])
            t = svc.submit(q, deadline=op[3])
            log["queries"][t] = (op[1], q)
            pending.append(t)
            continue
        if op[0] == "advance":
            clk.advance(op[1])
            continue
        if op[0] == "update":
            svc.apply_updates(inserts=op[1])
            log["cache"].append(sorted(_key(q) for q in svc._cache))
            continue
        if op[0] == "swap":
            with pytest.warns(DeprecationWarning):
                svc.update_graph(svc.csr)
            log["cache"].append(sorted(_key(q) for q in svc._cache))
            continue
        done = svc.poll() if op[0] == "poll" else svc.flush()
        log["tickets"].append(done)
        for t in done:
            log["results"][t] = svc.result(t)
    # tickets a deadline flush served inside submit()
    served = {t for d in log["tickets"] for t in d}
    log["auto"] = sorted(t for t in pending if t not in served)
    for t in log["auto"]:
        log["results"][t] = svc.result(t)
    log["stats"] = svc.stats.as_dict()
    log["epoch"] = svc.epoch
    log["spans"] = [(s.name, s.ts, s.dur, s.tid, s.args)
                    for s in obs.spans.spans()]
    log["level_runs"] = [(r["name"], r["t0"], r["t1"],
                          [lv.as_dict() for lv in r["levels"]])
                         for r in obs.level_runs]
    log["metrics"] = obs.metrics.snapshot()
    log["svc"] = svc
    return log


@pytest.fixture(scope="module")
def streams():
    n = BLOBS.n_rows
    with pytest.MonkeyPatch.context() as mp:
        for name in ("sssp.delta_scale", "engine.switch_frac",
                     "engine.push_slack"):
            mp.setitem(TT.DEFAULTS, name, RT.resolve(name, n=n))
        ref = _run_service(RS, RObs, RMetrics, BLOBS)
        got = _run_service(TS, TObs, TMetrics, port(BLOBS))
    return ref, got


def test_service_flushes_the_same_tickets_in_order(streams):
    ref, got = streams
    assert got["tickets"] == ref["tickets"]
    assert got["auto"] == ref["auto"]
    assert sorted(got["results"]) == sorted(ref["results"])
    assert len(ref["results"]) == len(ref["queries"])
    assert ref["auto"], "the stream should trip a deadline flush in submit"


def test_service_traversal_answers_match(streams):
    ref, got = streams
    n_checked = 0
    for t, (kind, _) in ref["queries"].items():
        a, b = ref["results"][t], got["results"][t]
        if kind == "reach":
            assert type(b) is bool and a == b, t
        elif kind == "dist":
            assert type(b) is float
            assert np.float32(a).tobytes() == np.float32(b).tobytes(), t
        else:
            continue
        n_checked += 1
    assert n_checked >= 20


def test_service_ppr_answers_match(streams):
    ref, got = streams
    n_ppr = 0
    for t, (kind, q) in ref["queries"].items():
        if kind != "ppr":
            continue
        (ri, rs), (ti, ts) = ref["results"][t], got["results"][t]
        assert ti.dtype == np.int32 and ts.dtype == np.float32
        assert ti.shape == ts.shape == (q.k,)
        np.testing.assert_allclose(ts, rs, rtol=RTOL, atol=ATOL)
        gaps = np.abs(np.diff(np.asarray(rs)))
        clear = np.ones(q.k, bool)
        clear[:-1] &= gaps > 1e-5
        clear[1:] &= gaps > 1e-5
        np.testing.assert_array_equal(ti[clear], np.asarray(ri)[clear])
        n_ppr += 1
    assert n_ppr >= 3


def test_service_samples_are_real_neighbours(streams):
    ref, got = streams
    indptr, indices = np.asarray(BLOBS.indptr), np.asarray(BLOBS.indices)
    n_sample = 0
    for t, (kind, q) in ref["queries"].items():
        if kind != "sample":
            continue
        draw = got["results"][t]
        assert draw.shape == np.asarray(ref["results"][t]).shape == (q.fanout,)
        row = set(indices[indptr[q.vertex]: indptr[q.vertex + 1]].tolist())
        assert set(draw.tolist()) <= (row or {q.vertex})
        n_sample += 1
    assert n_sample >= 3


def test_service_stats_match(streams):
    ref, got = streams
    assert got["stats"] == ref["stats"]
    st = ref["stats"]
    assert st["cache_hits"] and st["deadline_queries"] and st["updates"] == 1
    assert st["cache_evicted"] and st["deadline_misses"]
    assert got["epoch"] == ref["epoch"] == 2


def test_service_cache_matches_after_updates(streams):
    ref, got = streams
    assert got["cache"] == ref["cache"]
    # the confined update left blob B's entries alone
    assert any(k[1] >= 128 for k in ref["cache"][0])
    assert ref["cache"][1] == []     # update_graph evicts everything


def test_service_spans_match(streams):
    ref, got = streams
    assert len(got["spans"]) == len(ref["spans"])
    for r, t in zip(ref["spans"], got["spans"]):
        assert t == r
    names = {s[0] for s in ref["spans"]}
    assert names == {"enqueue", "flush_wait", "engine", "readback"}


def test_service_level_runs_match(streams):
    ref, got = streams
    assert got["level_runs"] == ref["level_runs"]
    assert {r[0].split("@")[0] for r in ref["level_runs"]} == \
        {"reach", "dist", "ppr"}


def test_service_metrics_match(streams):
    ref, got = streams
    assert got["metrics"] == ref["metrics"]
    assert got["metrics"]["service.cache_invalidations"] > 0


# ---------------------------------------------------------------------------
# NeighborSample by distribution
# ---------------------------------------------------------------------------

def _tsvc(g=None, **kw):
    kw.setdefault("batch_budget", 4)
    return TS.GraphService(port(G) if g is None else g, **kw)


def test_sample_key_is_splitmix64():
    """The draw key and bits equal a numpy uint64 splitmix64, the
    device-independent spec the card test relies on."""
    M = (1 << 64) - 1

    def mix(z):
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M
        return z ^ (z >> 31)

    def fold(k, d):
        return mix(mix((k + 0x9E3779B97F4A7C15) & M) ^ (d & M))

    data = [0, 1, 7, 2**31 - 1, 2**40 + 3, -5]
    got = TE.fold_in(torch.tensor(123456789), torch.tensor(data))
    assert [v & M for v in got.tolist()] == [fold(123456789, d) for d in data]
    bits = TE._srl(TE._mix64(got), 34)
    assert [int(b) for b in bits] == [mix(fold(123456789, d)) >> 34
                                      for d in data]


def test_sample_keys_follow_the_spec():
    """A query's draws are the splitmix64 keys of (service seed, epoch,
    vertex, fanout, query seed, slot), every word taken mod 2**64, so any
    int seed is served."""
    svc = _tsvc(seed=-7, batch_budget=8)
    indptr, indices = np.asarray(G.indptr), np.asarray(G.indices)
    for q in (TS.NeighborSample(9, fanout=3, seed=2**70 + 5),
              TS.NeighborSample(9, fanout=3, seed=-1)):
        draw = svc.query(q)
        key = torch.tensor(-7)
        for word in (0, q.vertex, q.fanout,
                     np.uint64(q.seed % 2**64).view(np.int64)):
            key = TE.fold_in(key, int(word))
        keys = TE.fold_in(key, torch.arange(3))
        r = TE._srl(TE._mix64(keys), 34).numpy()
        lo, deg = indptr[9], indptr[10] - indptr[9]
        np.testing.assert_array_equal(draw, indices[lo + r % deg])


def test_sample_picks_real_neighbours_and_sinks_stay():
    g = port(BLOBS)
    indptr, indices = np.asarray(BLOBS.indptr), np.asarray(BLOBS.indices)
    deg = np.diff(indptr)
    sinks = np.flatnonzero(deg == 0)
    assert sinks.size
    svc = _tsvc(g, batch_budget=8)
    verts = list(range(0, 256, 7)) + sinks.tolist()
    tickets = [svc.submit(TS.NeighborSample(int(v), fanout=3, seed=1))
               for v in verts]
    svc.flush()
    for v, t in zip(verts, tickets):
        draw = svc.result(t)
        assert draw.dtype == np.int32 and draw.shape == (3,)
        if deg[v] == 0:
            assert (draw == v).all()
        else:
            assert set(draw.tolist()) <= set(
                indices[indptr[v]: indptr[v + 1]].tolist())


def test_sample_draw_independent_of_batch():
    q = TS.NeighborSample(9, fanout=2, seed=3)
    alone = _tsvc(seed=5).query(q)
    svc = _tsvc(seed=5)
    ts = [svc.submit(TS.NeighborSample(v, fanout=1)) for v in (1, 2)]
    t = svc.submit(q)
    svc.flush()
    assert svc.stats.batches == 1 and svc.stats.lanes_used == 4
    np.testing.assert_array_equal(svc.result(t), alone)
    assert [svc.result(x).shape for x in ts] == [(1,), (1,)]
    # a wider budget pads the batch differently: the same draw
    np.testing.assert_array_equal(_tsvc(seed=5, batch_budget=32).query(q),
                                  alone)


def test_sample_cache_follows_partitions():
    g = port(BLOBS)
    svc = _tsvc(g)
    q = TS.NeighborSample(200, fanout=4, seed=2)       # partition 6
    first = svc.query(q)
    # an update confined to partition 0 leaves the entry alone
    svc.apply_updates(inserts=(np.array([1]), np.array([2])))
    batches = svc.stats.batches
    np.testing.assert_array_equal(svc.query(q), first)
    assert svc.stats.batches == batches and svc.stats.cache_hits == 1
    # mutating its partition evicts it: a batch runs, keyed by epoch 2
    svc.apply_updates(inserts=(np.array([201]), np.array([202])))
    again = svc.query(q)
    assert svc.stats.batches == batches + 1 and svc.epoch == 2
    fresh = TS.GraphService(svc.handle, batch_budget=4).query(q)
    np.testing.assert_array_equal(again, fresh)
    indptr, indices = svc.csr.indptr.numpy(), svc.csr.indices.numpy()
    assert set(again.tolist()) <= set(indices[indptr[200]:
                                              indptr[201]].tolist())


def test_sample_uniform_on_a_hub():
    from scipy import stats as sps
    indptr, indices = np.asarray(G.indptr), np.asarray(G.indices)
    hub = int(np.argmax(np.diff(indptr)))
    nbrs = indices[indptr[hub]: indptr[hub + 1]]
    svc = _tsvc(batch_budget=64, cache_capacity=0, seed=11)
    draws = np.concatenate([
        svc.query(TS.NeighborSample(hub, fanout=64, seed=s))
        for s in range(60)])
    pos = np.searchsorted(nbrs, draws)
    assert (nbrs[pos] == draws).all()
    counts = np.bincount(pos, minlength=nbrs.size)
    p = sps.chisquare(counts).pvalue
    assert p > 1e-3, (nbrs.size, p)


# ---------------------------------------------------------------------------
# error paths and cost priors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    "unknown type", "source out of range", "target out of range",
    "vertex out of range", "fanout over budget", "fanout zero",
    "k over ppr_k_max", "negative deadline", "bad placement", "zero budget"])
def test_error_paths_match_reference(case):
    errs = []
    for mod, g in ((RS, G), (TS, port(G))):
        kw = {"batch_budget": 0} if case == "zero budget" else {}
        if case == "bad placement":
            kw["placement"] = "eventual"
        with pytest.raises((TypeError, ValueError)) as e:
            svc = mod.GraphService(g, **{"batch_budget": 4, "ppr_k_max": 16,
                                         **kw})
            q, dl = {
                "unknown type": (("reach", 0, 1), None),
                "source out of range": (mod.Reachability(128, 0), None),
                "target out of range": (mod.Distance(0, -1), None),
                "vertex out of range": (mod.NeighborSample(999), None),
                "fanout over budget": (mod.NeighborSample(0, fanout=5),
                                       None),
                "fanout zero": (mod.NeighborSample(0, fanout=0), None),
                "k over ppr_k_max": (mod.PPRTopK(0, k=17), None),
                "negative deadline": (mod.Reachability(0, 1), -1.0),
            }[case]
            svc.submit(q, deadline=dl)
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]


def test_mesh_is_refused():
    with pytest.raises(NotImplementedError, match="A.8"):
        TS.GraphService(port(G), mesh=object())


def test_claimed_ticket_errors_match():
    msgs = []
    for mod, g in ((RS, G), (TS, port(G))):
        svc = mod.GraphService(g, batch_budget=4)
        t = svc.submit(mod.NeighborSample(3))
        with pytest.raises(KeyError) as pend:
            svc.result(t)
        svc.flush()
        svc.result(t)
        with pytest.raises(KeyError) as claimed:
            svc.result(t)
        msgs.append((str(pend.value), str(claimed.value)))
    assert msgs[0] == msgs[1]


def _bench(path, n, doc):
    (path / f"BENCH_pr{n}.json").write_text(json.dumps(doc))


@pytest.mark.parametrize("case", ["none", "newest wins", "malformed",
                                  "distributed", "negative qps", "budget 16"])
def test_load_cost_priors_matches_reference(tmp_path, case):
    good = {"service": {"budgets": {"32": {"qps": 640.0},
                                    "16": {"qps": 100.0}}},
            "service_distributed": {"budgets": {"32": {"latency_p50_ms":
                                                       12.5}}}}
    if case != "none":
        _bench(tmp_path, 3, {"service": {"budgets": {"32": {"qps": 1.0}}}})
        _bench(tmp_path, 12, {"service": {}} if case == "malformed" else
               {"service": {"budgets": {"32": {"qps": -4.0}}}}
               if case == "negative qps" else good)
        (tmp_path / "BENCH_prx.json").write_text("{}")
    kw = {"bench_dir": str(tmp_path),
          "distributed": case == "distributed",
          "budget": 16 if case == "budget 16" else 32}
    want = RS.load_cost_priors(**kw)
    assert TS.load_cost_priors(**kw) == want
    assert bool(want) == (case in ("newest wins", "distributed",
                                   "budget 16"))
