"""Port parity for tuning: ``repro_torch.tune`` against the live reference
``repro.tune`` on the CPU.

* The port's ``autotune(6, device="cpu")`` equals the reference's live
  ``autotune(6, backend="cpu")`` in every swept parameter and every score
  (the reference's entry is computed once per module, ~11 s of Pallas
  interpret mode).  The two packages' own kernel tiles (segment_sum,
  flash_attention) differ by design and ship as each one's default.
* The cost models equal the reference's: the BFS level sets, the stream
  bytes of each candidate (scales 7 and 12), the routed-byte replay, the
  measured SSSP iterations, the lane-budget model and the hysteresis pick.
* The committed "cpu" entries equal ``python -m repro_torch.tune --device
  cpu --scale 7 --scale 12``.
* ``resolve``: explicit > entry (backend from the data's device, nearest
  scale within the window, ties to the smaller) > default, with
  ``tune.autotune_fallback`` counted exactly on a miss.
* ``build_pull_operand`` routes through the resolver; the kernel lane's
  rows; the space mirrors the reference's grids and the CUDA kernel's
  shared memory.
"""
import importlib
import json
import os

import numpy as np
import pytest
import torch

from repro import tune as RT
from repro.tune import sweep as RS
from repro.tune import space as RSP
from repro.core import engine as RE
from repro_torch import tune as TT
from repro_torch.core import engine as TE
from repro_torch.core.graph import to_bbcsr
from repro_torch.obs import get_registry
from repro_torch.tune import __main__ as TCLI
from repro_torch.tune import space as TSP
from repro_torch.tune import sweep as TS
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

# the module (the package's ``resolve`` is the function)
TR = importlib.import_module("repro_torch.tune.resolve")

PORT_TILES = ("kernels.segment_sum.block_n",
              "kernels.flash_attention.block_q",
              "kernels.flash_attention.block_k")
SECTIONS = ("kernels.bbcsr_add", "kernels.bbcsr_min")


@pytest.fixture(autouse=True)
def _fresh_doc_cache():
    TT.clear_cache()
    yield
    TT.clear_cache()


@pytest.fixture(scope="module")
def ref6():
    return RT.autotune(6, backend="cpu", reps=1)


def _fallbacks() -> int:
    return get_registry().counter("tune.autotune_fallback").value


def _write(path, entries) -> str:
    path.write_text(json.dumps({"version": 1, "tool": "test",
                                "entries": entries}))
    return str(path)


def _roundtrip(obj):
    return json.loads(json.dumps(obj))


# ---------------------------------------------------------------------------
# The CPU sweep against the reference's
# ---------------------------------------------------------------------------

def test_autotune_cpu_equals_reference(ref6):
    got = TT.autotune(6, device="cpu")
    assert got["backend"] == "cpu" and got["scale"] == 6
    assert set(got["params"]) == set(TT.DEFAULTS)
    want = dict(ref6["params"], **{k: TT.DEFAULTS[k] for k in PORT_TILES})
    assert got["params"] == want
    assert _roundtrip(got["scores"]) == _roundtrip(ref6["scores"])
    # every candidate was admitted and scored on both sides
    for section in SECTIONS:
        assert len(got["scores"][section]["candidates"]) == \
            len(TSP.kernel_grid(section)) == 8


def test_space_mirrors_reference():
    assert TSP.GRIDS == RSP.GRIDS
    assert TSP.HYSTERESIS == RSP.HYSTERESIS
    for name, value in TSP.DEFAULTS.items():
        if name not in PORT_TILES:
            assert RSP.DEFAULTS[name] == value
    for section in SECTIONS:
        assert TSP.kernel_grid(section) == RSP.kernel_grid(section)


@pytest.mark.parametrize("block_rows, smem", [(128, 28672), (256, 36864)])
def test_smem_mirror_admits_both_block_rows(block_rows, smem):
    # csrc/bbcsr.cu: 4 * kWarps * (5 * kWin + kSlices * block_rows)
    assert TSP.bbcsr_smem_bytes(block_rows) == smem <= TSP.SMEM_LIMIT
    assert TSP.bbcsr_smem_bytes(1 << 14) > TSP.SMEM_LIMIT


@pytest.fixture(scope="module")
def probes():
    """The probe graph at scale 7 and 12 in both packages."""
    out = {}
    for scale in (7, 12):
        r = RS.probe_graph(scale)
        t = TS.probe_graph(scale, device="cpu")
        out[scale] = (r, t, RS.bfs_level_sets(r), TS.bfs_level_sets(t))
    return out


@pytest.mark.parametrize("scale", [7, 12])
def test_level_sets_equal_reference(probes, scale):
    _, _, r_lv, t_lv = probes[scale]
    assert len(r_lv) == len(t_lv)
    for a, b in zip(r_lv, t_lv):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scale", [7, 12])
@pytest.mark.parametrize("section", SECTIONS)
def test_stream_bytes_equal_reference(probes, scale, section):
    r, t, r_lv, t_lv = probes[scale]
    t_t = t.transpose()
    for cfg in TSP.kernel_grid(section):
        r_bb, _ = RS._kernel_operands(r, cfg)
        t_bb = to_bbcsr(t_t, **cfg)
        assert TS.bbcsr_stream_bytes(t_bb) == RS.bbcsr_stream_bytes(r_bb)
        assert TS._spmspv_stream_bytes(t_bb, t_lv) == \
            RS._spmspv_stream_bytes(r_bb, r_lv)


def test_route_cost_and_engine_sweep_equal_reference(probes):
    r, t, r_lv, t_lv = probes[7]
    deg = np.diff(np.asarray(r.indptr))
    for f in TSP.GRIDS["engine"]["switch_frac"]:
        for s in TSP.GRIDS["engine"]["push_slack"]:
            assert TS._route_cost(t_lv, deg, t.n_rows, t.nnz, f, s) == \
                RS._route_cost(r_lv, deg, r.n_rows, r.nnz, f, s)
    assert TS._sweep_engine(t, t_lv) == RS._sweep_engine(r, r_lv)


def test_delta_and_budget_sweeps_equal_reference(probes):
    r, t, _, _ = probes[7]
    assert TS._sweep_delta(t) == RS._sweep_delta(r)
    assert TS._sweep_budget(t) == RS._sweep_budget(r)
    sources = np.linspace(0, t.n_rows - 1, 8).astype(np.int64)
    assert TS._eccentricities(t, sources) == RS._eccentricities(r, sources)


@pytest.mark.parametrize("table", [
    [({"a": 0}, 100.0), ({"a": 1}, 91.0)],       # inside the hysteresis
    [({"a": 0}, 100.0), ({"a": 1}, 89.0), ({"a": 2}, 80.0)],
    [({"a": 0}, 100.0), ({"a": 1}, 120.0)],
    [({"a": 0}, 100.0), ({"a": 1}, 85.0), ({"a": 2}, 85.0)],  # first wins
])
def test_pick_equals_reference(table):
    assert TS._pick(table) == RS._pick(table)


# ---------------------------------------------------------------------------
# The committed file
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [7, 12])
def test_committed_cpu_entries_match_regeneration(scale):
    committed = [e for e in TT.load_tuned()["entries"]
                 if (e["backend"], e["scale"]) == ("cpu", scale)]
    assert len(committed) == 1
    fresh = _roundtrip(TT.autotune(scale, device="cpu"))
    assert committed[0] == fresh


def test_committed_card_entries_name_the_card():
    cards = {e["scale"]: e for e in TT.load_tuned()["entries"]
             if e["backend"] == "cuda"}
    assert sorted(cards) == [16, 20]
    for e in cards.values():
        assert e["device"].startswith("NVIDIA H100")
        assert e["power_limit"].endswith(" W")
        assert set(e["params"]) == set(TT.DEFAULTS)
        for section in SECTIONS:
            sc = e["scores"][section]
            assert sc["unit"] == "us"
            timed = sc["candidates"] + sc["rejected"]
            assert len(timed) == len(sc["operand_gb"]) == 8
            assert all(us > 0 for _, us in timed)
        # the min / max combines are exact: the gate admits every geometry
        assert e["scores"]["kernels.bbcsr_min"]["rejected"] == []
        assert {str(b): TSP.bbcsr_smem_bytes(b) for b in (128, 256)} == \
            e["smem_bytes"]


def test_cli_merges_by_backend_and_scale(tmp_path, capsys):
    card = {"backend": "cuda", "scale": 7, "params": {}}
    stale = {"backend": "cpu", "scale": 7, "params": {}}
    out = _write(tmp_path / "tuned.json", [stale, card])
    assert TCLI.main(["--device", "cpu", "--scale", "7", "--out", out]) == 0
    doc = json.loads((tmp_path / "tuned.json").read_text())
    assert doc["entries"][1] == card
    want = [e for e in TT.load_tuned()["entries"]
            if (e["backend"], e["scale"]) == ("cpu", 7)]
    assert doc["entries"][:1] == want
    assert "winner" in capsys.readouterr().out


def test_cli_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TCLI.main(["--scale", "7", "--out", str(tmp_path / "t.json")])
    with pytest.raises(ValueError):
        TT.stream_peak_bytes_per_s(device="cpu")


# ---------------------------------------------------------------------------
# resolve: precedence, window, backend, counter
# ---------------------------------------------------------------------------

ENTRIES = [
    {"backend": "cpu", "scale": 7, "params": {"engine.switch_frac": 0.25,
                                              "sssp.delta_scale": 7.0}},
    {"backend": "cpu", "scale": 12, "params": {"engine.switch_frac": 0.125,
                                               "sssp.delta_scale": 12.0}},
    {"backend": "cpu", "scale": 3, "params": {"sssp.delta_scale": 3.0}},
    {"backend": "cuda", "scale": 8, "params": {"engine.switch_frac": 0.5,
                                               "sssp.delta_scale": 99.0}},
]
DEF_F = TSP.DEFAULTS["engine.switch_frac"]
DEF_D = TSP.DEFAULTS["sssp.delta_scale"]


@pytest.mark.parametrize("name, kwargs, want, fires", [
    # an explicit value wins, even over a matching entry: no fallback
    ("engine.switch_frac", dict(explicit=0.5, n=128, device="cpu"), 0.5, 0),
    # the entry of the data's backend at the nearest scale in the window
    ("engine.switch_frac", dict(n=128, device="cpu"), 0.25, 0),
    ("engine.switch_frac", dict(n=128, device=torch.device("cpu")), 0.25, 0),
    ("engine.switch_frac", dict(scale=11, device="cpu"), 0.125, 0),
    ("engine.switch_frac", dict(n=128, scale=12, device="cpu"), 0.125, 0),
    # 3 and 7 are both two from 5: the smaller scale wins the tie
    ("sssp.delta_scale", dict(scale=5, device="cpu"), 3.0, 0),
    # the nearest entry lacks the name: the default, counted
    ("engine.switch_frac", dict(scale=4, device="cpu"), DEF_F, 1),
    # outside the window of every entry: the default, counted
    ("engine.switch_frac", dict(scale=30, device="cpu"), DEF_F, 1),
    # backends never leak across; a call with no data resolves "cuda", and
    # so does a dry run's meta data (it traces the card's calls)
    ("sssp.delta_scale", dict(scale=8, device="cpu"), 7.0, 0),
    ("sssp.delta_scale", dict(scale=8, device="cuda:0"), 99.0, 0),
    ("sssp.delta_scale", dict(scale=8), 99.0, 0),
    ("engine.switch_frac", dict(scale=20), DEF_F, 1),
    ("sssp.delta_scale", dict(scale=8, device="meta"), 99.0, 0),
    ("sssp.delta_scale", dict(scale=8, device="xpu"), DEF_D, 1),
])
def test_resolve_precedence_window_backend(tmp_path, name, kwargs, want,
                                           fires):
    path = _write(tmp_path / "tuned.json", ENTRIES)
    before = _fallbacks()
    assert TT.resolve(name, path=path, **kwargs) == want
    assert _fallbacks() == before + fires


def test_resolve_missing_file_and_unknown_name(tmp_path):
    before = _fallbacks()
    absent = str(tmp_path / "absent.json")
    assert TT.resolve("engine.switch_frac", n=128, device="cpu",
                      path=absent) == DEF_F
    assert _fallbacks() == before + 1
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert TT.resolve("engine.switch_frac", device="cpu",
                      path=str(bad)) == DEF_F
    assert _fallbacks() == before + 2
    # an explicit value is an opt-out, not a degradation
    assert TT.resolve("engine.switch_frac", 0.5, path=absent) == 0.5
    assert _fallbacks() == before + 2
    with pytest.raises(KeyError):
        TT.resolve("engine.no_such_knob", path=absent)


def test_tuned_file_is_read_once_per_version(tmp_path, monkeypatch):
    path = _write(tmp_path / "tuned.json", [
        {"backend": "cpu", "scale": 7, "params": {"sssp.delta_scale": 7.0}}])
    stats = []
    real = TR.os.path.getmtime
    monkeypatch.setattr(TR.os.path, "getmtime",
                        lambda p: stats.append(p) or real(p))
    for _ in range(3):
        assert TT.resolve("sssp.delta_scale", scale=7, device="cpu",
                          path=path) == 7.0
    assert len(stats) == 1          # one stat per RECHECK_S, not per call
    _write(tmp_path / "tuned.json", [
        {"backend": "cpu", "scale": 7, "params": {"sssp.delta_scale": 8.0}}])
    os.utime(path, (1, 1))          # another mtime, whatever the clock
    monkeypatch.setattr(TR, "RECHECK_S", 0.0)
    assert TT.resolve("sssp.delta_scale", scale=7, device="cpu",
                      path=path) == 8.0


def test_build_pull_operand_routes_through_resolver(tmp_path, monkeypatch):
    g = TS.probe_graph(7, device="cpu")
    geo = {"add": (128, 256, 256), "min": (256, 256, 512)}
    params = {f"kernels.bbcsr_{c}.{k}": v for c, vals in geo.items()
              for k, v in zip(("block_rows", "block_cols", "tile_nnz"), vals)}
    monkeypatch.setattr(TR, "TUNED_PATH", _write(
        tmp_path / "tuned.json",
        [{"backend": "cpu", "scale": 7, "params": params},
         {"backend": "cuda", "scale": 7, "params": {}}]))
    before = _fallbacks()
    for combine in ("add", "min"):
        bb = TE.build_pull_operand(g, combine=combine)
        assert (bb.block_rows, bb.block_cols, bb.tile_nnz) == geo[combine]
    assert _fallbacks() == before
    # explicit tile kwargs still win per key
    bb = TE.build_pull_operand(g, combine="add", block_rows=256, tile_nnz=512)
    assert (bb.block_rows, bb.block_cols, bb.tile_nnz) == (256, 256, 512)
    assert _fallbacks() == before
    # the reference's operand at the same geometry is the same bytes
    r = RS.probe_graph(7)
    rb = RE.build_pull_operand(r, combine="add", block_rows=128,
                               block_cols=256, tile_nnz=256)
    tb = TE.build_pull_operand(g, combine="add")
    np.testing.assert_array_equal(np.asarray(rb.vals), tb.vals.numpy())
    np.testing.assert_array_equal(np.asarray(rb.cols_local),
                                  tb.cols_local.numpy())


def test_committed_cpu_entry_drives_the_cpu_path():
    g = TS.probe_graph(7, device="cpu")
    before = _fallbacks()
    bb = TE.build_pull_operand(g)
    entry = TT.lookup("cpu", 7)
    assert (bb.block_rows, bb.block_cols, bb.tile_nnz) == tuple(
        entry["params"][f"kernels.bbcsr_add.{k}"]
        for k in ("block_rows", "block_cols", "tile_nnz"))
    assert _fallbacks() == before


# ---------------------------------------------------------------------------
# The kernel measurement lane
# ---------------------------------------------------------------------------

def test_kernel_rows_shape_and_cpu_gate_metric():
    rows = TT.kernel_rows(7, device="cpu", reps=1)
    by = {r["name"]: r for r in rows}
    assert set(by) == {"kernels/bbcsr_add/default", "kernels/bbcsr_add/tuned",
                       "kernels/bbcsr_min/default", "kernels/bbcsr_min/tuned",
                       "kernels/flash_attn_oracle_b4h8s1024",
                       "kernels/embedding_bag_oracle_8k_lookups"}
    for r in rows:
        assert r["measured"] == "plain"
        assert np.isfinite(r["bytes_per_s"]) and r["bytes_per_s"] > 0
        assert r["bytes_model"] > 0 and r["us"] > 0
    entry = TT.lookup("cpu", 7)
    for kern in ("bbcsr_add", "bbcsr_min"):
        tuned = by[f"kernels/{kern}/tuned"]
        assert tuned["config"] == {
            k: entry["params"][f"kernels.{kern}.{k}"]
            for k in ("block_cols", "block_rows", "tile_nnz")}
        # the hysteresis rule never picks more modeled traffic
        assert tuned["bytes_model"] <= by[f"kernels/{kern}/default"][
            "bytes_model"]
