"""Port parity for observability and the traffic model: ``repro_torch.obs``
(metrics registry, spans, Chrome-trace export, ``Observability``, the
summarize CLI) and ``repro_torch.core.traffic`` against the reference's
modules, on the same inputs.

Histogram percentiles and snapshots must be the reference's floats bit for
bit (held to the reference's live output, not to the one-bucket property
the reference itself fails, ROADMAP §C.4); spans recorded on a fake clock
equal field by field, clipping included; trace documents equal as JSON,
with the same verdicts on malformed documents; every traffic function and
``RouteByteCounter`` method equal over a grid of shard counts, lane counts,
capacities and byte sizes.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import traffic as RTR
from repro.obs import __main__ as RCLI
from repro.obs import export as REX
from repro.obs import metrics as RM
from repro.obs import spans as RSP
from repro.obs import trace as RTRACE
from repro.obs import Observability as RObs
from repro_torch.core import traffic as TTR
from repro_torch.obs import __main__ as TCLI
from repro_torch.obs import export as TEX
from repro_torch.obs import metrics as TM
from repro_torch.obs import spans as TSP
from repro_torch.obs import trace as TTRACE
from repro_torch.obs import Observability as TObs

ROOT = pathlib.Path(__file__).resolve().parent.parent
PCTS = (0, 0.1, 1, 10, 25, 50, 75, 90, 95, 99, 99.9, 100)


def _samples(case):
    rng = np.random.default_rng(7)
    if case == "service latencies":
        # the reference's fixed example (tests/test_obs.py)
        return np.concatenate([rng.uniform(1e-4, 5e-3, 300),
                               rng.uniform(0.05, 2.0, 60), [40.0, 120.0]])
    if case == "edges":
        # its edge cases: NaN skipped, 0 and 1e9 clamp; plus the bucket
        # edges themselves and values below lo
        return np.array([float("nan"), 0.0, 1e9, 1e-6, 1e-7, 1.12e-6,
                         -3.0, 1.0, float("nan"), 1e-6 * 1.12 ** 40])
    if case == "lognormal":
        return rng.lognormal(-6, 2, 2000)
    return np.array([])


@pytest.mark.parametrize("case", ["service latencies", "edges",
                                  "lognormal", "empty"])
@pytest.mark.parametrize("kw", [{}, {"lo": 1e-3, "growth": 2.0,
                                     "n_buckets": 8}])
def test_histogram_matches_reference(case, kw):
    hs = [mod.Histogram("lat", **kw) for mod in (RM, TM)]
    for x in _samples(case):
        for h in hs:
            h.observe(float(x))
    r, t = hs
    for pct in PCTS:
        assert t.percentile(pct).hex() == r.percentile(pct).hex(), pct
    assert t.snapshot() == r.snapshot()
    assert (t.count, t.sum, t.mean) == (r.count, r.sum, r.mean)
    assert list(t._buckets) == list(r._buckets)
    assert [t.bucket_upper(i) for i in range(8)] == \
        [r.bucket_upper(i) for i in range(8)]


@pytest.mark.parametrize("kw", [{"lo": 0.0}, {"growth": 1.0},
                                {"n_buckets": 0}])
def test_histogram_rejects_what_the_reference_rejects(kw):
    msgs = []
    for mod in (RM, TM):
        with pytest.raises(ValueError) as e:
            mod.Histogram("x", **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("a").inc()
    reg.counter("a").inc(4)
    reg.gauge("g").set(2.5)
    reg.gauge("g").set(-1)
    h = reg.histogram("h", growth=1.5)
    for x in (1e-3, 2e-3, 0.5):
        h.observe(x)
    assert reg.histogram("h") is h          # create-on-first-use
    reg.counter("b")
    with pytest.raises(ValueError) as e:
        reg.counter("a").inc(-1)
    snap = reg.snapshot()
    reg.reset()
    return snap, str(e.value), reg.snapshot(), \
        mod.get_registry() is mod.REGISTRY


def test_registry_matches_reference():
    assert _drive_registry(TM) == _drive_registry(RM)


def _drive_spans(mod, capacity):
    t = [0.0]
    rec = mod.SpanRecorder(clock=lambda: t[0], capacity=capacity)
    with rec.span("outer", tid=1, kind="x") as args:
        t[0] = 1.0
        with rec.span("inner", tid=1):
            t[0] = 2.0
        rec.record("nested-record", 1.2, 1.8, tid=1)
        args["route_bytes"] = 64
        t[0] = 3.0
    rec.record("wait", 1.5, 4.0, tid=1)        # clipped forward to 3.0
    rec.record("late", 5.0, 4.5, tid=1)        # t0 past t1: zero width
    t[0] = 6.0
    rec.record("open-end", 5.5, tid=2, ticket=3)
    rec.record("other-tid", 0.5, 1.0, tid=3)
    with rec.span("after", tid=1):
        t[0] = 7.0
    out = [dataclasses.asdict(s) for s in rec.spans()]
    n = len(rec)
    rec.clear()
    return out, n, len(rec), rec.now()


@pytest.mark.parametrize("capacity", [65536, 3])
def test_spans_match_reference(capacity):
    got, want = _drive_spans(TSP, capacity), _drive_spans(RSP, capacity)
    assert got == want
    assert any(s["name"] == "wait" and s["ts"] == 3.0 for s in want[0]) \
        or capacity == 3


def _levels(mod, rows, pushes, pulls):
    stats = {"trace": rows, "pushes": pushes, "pulls": pulls}
    return mod.decode_level_trace(stats)


def _doc(rec_mod, ex_mod, trace_mod, as_tensor):
    t = [0.0]
    rec = rec_mod.SpanRecorder(clock=lambda: t[0])
    rec.record("enqueue", 0.0, 0.001, tid=1, kind="reach", ticket=0)
    rec.record("flush_wait", 0.0, 0.002, tid=2, kind="reach")
    rec.record("engine", 0.002, 0.0105, tid=2, kind="reach",
               route_bytes=4096)
    rec.record("readback", 0.0105, 0.011, tid=2, kind="reach")
    rows = np.array([[5, 1, 0, 0], [700, 0, 0, 0], [30, 1, 0, 0],
                     [0, 0, 0, 0]], np.int32)
    arr = torch.as_tensor(rows) if as_tensor else rows
    runs = [{"name": "reach@0", "t0": 0.002, "t1": 0.0105,
             "levels": _levels(trace_mod, arr, 2, 1)},
            {"name": "empty", "t0": 0.0, "t1": 1.0, "levels": []}]
    return ex_mod.build_chrome_trace(rec.spans(), runs,
                                     {"service.cost_ewma_updates": 1})


def test_chrome_trace_matches_reference():
    want = _doc(RSP, REX, RTRACE, False)
    got = _doc(TSP, TEX, TTRACE, True)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert TEX.validate_chrome_trace(got) == []
    assert TEX.summarize(got) == REX.summarize(want)
    assert TEX.format_summary(TEX.summarize(got)) == \
        REX.format_summary(REX.summarize(want))


BAD_DOCS = {
    "partial overlap and missing field": {"traceEvents": [
        {"ph": "X", "name": "a", "pid": 0, "tid": 1, "ts": 0.0, "dur": 10.0},
        {"ph": "X", "name": "b", "pid": 0, "tid": 1, "ts": 5.0, "dur": 10.0},
        {"ph": "X", "name": "c", "pid": 0, "tid": 2, "ts": 0.0}]},
    "empty": {"traceEvents": []},
    "no events": {"displayTimeUnit": "ms"},
    "not a list": {"traceEvents": {"a": 1}},
    "tie within slack": {"traceEvents": [
        {"ph": "X", "name": "p", "pid": 0, "tid": 1, "ts": 0.0, "dur": 10.0},
        {"ph": "X", "name": "c", "pid": 0, "tid": 1, "ts": 2.0, "dur": 8.4}]},
    "nested and disjoint": {"traceEvents": [
        {"ph": "X", "name": "p", "pid": 0, "tid": 1, "ts": 0.0, "dur": 10.0},
        {"ph": "X", "name": "c", "pid": 0, "tid": 1, "ts": 2.0, "dur": 3.0},
        {"ph": "X", "name": "d", "pid": 0, "tid": 1, "ts": 20.0, "dur": 1.0},
        {"ph": "B", "name": "meta", "pid": 0, "tid": 1, "ts": 1.0,
         "dur": 50.0},
        {"name": "lvl", "cat": "level", "pid": 0, "tid": 1000, "ts": 0.0,
         "dur": 4.0, "args": {"route_bytes": 12}}]},
    "missing pid": {"traceEvents": [{"ph": "X", "name": "a", "tid": 1,
                                     "ts": 0.0, "dur": 1.0}]},
}


def _outcome(fn, doc):
    """fn(doc), or the type of what it raised: the reference's summarize
    raises on some malformed documents, and the port's must too."""
    try:
        return fn(doc)
    except Exception as e:        # compared, not swallowed
        return type(e)


@pytest.mark.parametrize("name", sorted(BAD_DOCS))
def test_validator_and_summary_match_reference(name):
    doc = BAD_DOCS[name]
    want = REX.validate_chrome_trace(doc)
    assert TEX.validate_chrome_trace(doc) == want
    assert _outcome(TEX.summarize, doc) == _outcome(REX.summarize, doc)
    if name == "partial overlap and missing field":
        assert any("partially overlaps" in e for e in want)


def _observability(mod, trace_mod, metrics_mod, as_tensor):
    t = [0.0]
    obs = mod(clock=lambda: t[0], metrics=metrics_mod.MetricsRegistry())
    obs.metrics.counter("service.cache_invalidations").inc(2)
    obs.spans.record("engine", 0.0, 0.5, tid=mod.TID_SERVICE, kind="dist")
    rows = np.array([[1, 1, 0, 0], [9, 0, 0, 0]], np.int32)
    levels = obs.add_level_run("dist@0", 0.0, 0.5, {
        "trace": torch.as_tensor(rows) if as_tensor else rows,
        "pushes": 1, "pulls": 1})
    out = (mod.TID_CLIENT, mod.TID_SERVICE, [lv.as_dict() for lv in levels],
           obs.build_trace(), obs.summary())
    obs.clear()
    return out + (len(obs.spans), obs.level_runs)


def test_observability_matches_reference(tmp_path):
    want = _observability(RObs, RTRACE, RM, False)
    got = _observability(TObs, TTRACE, TM, True)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    obs = TObs(clock=lambda: 1.0, metrics=TM.MetricsRegistry())
    obs.spans.record("enqueue", 0.5, 1.0, tid=1)
    path = tmp_path / "t.json"
    from repro_torch.obs import export_chrome_trace
    doc = export_chrome_trace(str(path), obs)
    assert json.loads(path.read_text()) == doc


def _write(tmp_path, doc, name="trace.json"):
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.mark.parametrize("as_json", [False, True])
@pytest.mark.parametrize("valid", [True, False])
def test_cli_matches_reference(tmp_path, capsys, as_json, valid):
    doc = _doc(TSP, TEX, TTRACE, True) if valid else \
        {"traceEvents": BAD_DOCS["partial overlap and missing field"][
            "traceEvents"][:2]}
    argv = ["summarize", _write(tmp_path, doc)] + (["--json"] if as_json
                                                   else [])
    rc = TCLI.main(argv)
    got = capsys.readouterr().out
    assert rc == RCLI.main(argv) == (0 if valid else 1)
    assert got == capsys.readouterr().out


def test_cli_runs_as_a_module(tmp_path):
    path = _write(tmp_path, _doc(TSP, TEX, TTRACE, True))
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                          "summarize", path], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src")}, cwd=ROOT,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert "structurally valid" in out.stdout


# ---------------------------------------------------------------------------
# traffic model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_lanes", [1, 7, 31, 32, 33, 64, 100])
@pytest.mark.parametrize("packed", [False, True])
def test_batched_payload_bytes_matches(n_lanes, packed):
    assert TTR.batched_payload_bytes(n_lanes, packed=packed) == \
        RTR.batched_payload_bytes(n_lanes, packed=packed)


def test_batched_payload_bytes_rejects_no_lanes():
    msgs = []
    for mod in (RTR, TTR):
        with pytest.raises(ValueError) as e:
            mod.batched_payload_bytes(0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


GRID = [(s, c, p) for s in (1, 4, 8) for c in (1, 125, 4096)
        for p in (9, 13, 37)]


@pytest.mark.parametrize("shards,cap,payload", GRID)
def test_route_byte_functions_match(shards, cap, payload):
    assert TTR.push_level_route_bytes(shards, cap, payload) == \
        RTR.push_level_route_bytes(shards, cap, payload)
    assert TTR.push_level_route_bytes(shards, cap) == \
        RTR.push_level_route_bytes(shards, cap)
    assert TTR.flush_route_bytes(shards, cap, payload) == \
        RTR.flush_route_bytes(shards, cap, payload)


@pytest.mark.parametrize("placement", ["sync", "async"])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("prog", [0, 2])
def test_level_collectives_match(placement, compact, prog):
    kw = dict(placement=placement, compact=compact, program_collectives=prog)
    assert TTR.level_collectives(**kw) == RTR.level_collectives(**kw)


def _drive_counter(mod, shards, lanes):
    ctr = mod.RouteByteCounter(shards)
    item = mod.batched_payload_bytes(lanes, packed=lanes % 2 == 0)
    out = [ctr.push_level(1000), ctr.push_level(37, payload_bytes=item),
           ctr.pull_level(12345), ctr.flush_level(4096),
           ctr.flush_level(10, elem_bytes=4 * lanes), ctr.contract_level(77),
           ctr.contract_level(5, payload_bytes=20)]
    return out, dataclasses.asdict(ctr)


@pytest.mark.parametrize("shards", [1, 8, 64])
@pytest.mark.parametrize("lanes", [1, 32, 33])
def test_route_byte_counter_matches(shards, lanes):
    assert _drive_counter(TTR, shards, lanes) == \
        _drive_counter(RTR, shards, lanes)


def test_machine_model_matches():
    for name in ("ROUTE_PAYLOAD_BYTES", "CONTRACT_PAYLOAD_BYTES"):
        assert getattr(TTR, name) == getattr(RTR, name)
    for name in ("XEON", "PIUMA_NODE"):
        assert dataclasses.asdict(getattr(TTR, name)) == \
            dataclasses.asdict(getattr(RTR, name))
    assert {k: dataclasses.asdict(v) for k, v in TTR.SPMV_PROFILES.items()} \
        == {k: dataclasses.asdict(v) for k, v in RTR.SPMV_PROFILES.items()}
    assert {a: {k: dataclasses.asdict(v) for k, v in ps.items()}
            for a, ps in TTR.APP_PROFILES.items()} == \
        {a: {k: dataclasses.asdict(v) for k, v in ps.items()}
         for a, ps in RTR.APP_PROFILES.items()}


@pytest.mark.parametrize("app", sorted(RTR.APP_PROFILES))
def test_time_model_matches(app):
    rp, tp = RTR.APP_PROFILES[app], TTR.APP_PROFILES[app]
    for side in ("piuma", "xeon"):
        rm = RTR.PIUMA_NODE if side == "piuma" else RTR.XEON
        tm = TTR.PIUMA_NODE if side == "piuma" else TTR.XEON
        assert TTR.time_per_elem(tm, tp[side]) == \
            RTR.time_per_elem(rm, rp[side])
        for nodes in (1, 2, 16, 1024):
            assert TTR.multinode_time_per_elem(tm, tp[side], nodes) == \
                RTR.multinode_time_per_elem(rm, rp[side], nodes)
    assert TTR.speedup(tp["piuma"], tp["xeon"]) == \
        RTR.speedup(rp["piuma"], rp["xeon"])
    for name, p in TTR.SPMV_PROFILES.items():
        assert TTR.speedup(p) == RTR.speedup(RTR.SPMV_PROFILES[name])
