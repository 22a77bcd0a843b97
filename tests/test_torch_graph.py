"""Port parity: the graph substrate of ``repro_torch`` against ``repro``.

CSR, RMAT, transpose, padded ELL and BBCSR arrays must be byte-equal to the
reference's, at several tile geometries including empty row blocks; the
numpy converters must round-trip.  Also holds the port's two package rules:
no module imports JAX or the reference, and a default-device entry point
raises when no card is present.
"""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as RE
from repro.core import graph as RG
from repro.tune.space import DEFAULTS as REF_DEFAULTS
from repro_torch import tune as TT
from repro_torch.core import engine as TE
from repro_torch.core import graph as TG
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
BB_FIELDS = ("rows_local", "cols_local", "vals", "tile_rb", "tile_cb",
             "tile_init", "tile_cnt")
GEOMS = [(32, 64, 64), (16, 16, 8), (64, 32, 128), (4, 4, 4),
         (256, 512, 512)]


def _eq(ref, port):
    a, b = np.asarray(ref), port.cpu().numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def _eq_csr(r, t):
    for f in ("indptr", "indices", "values"):
        if getattr(r, f) is None:
            assert getattr(t, f) is None
        else:
            _eq(getattr(r, f), getattr(t, f))
    assert (r.n_rows, r.n_cols) == (t.n_rows, t.n_cols)


def _eq_bb(r, t):
    for f in BB_FIELDS:
        _eq(getattr(r, f), getattr(t, f))
    assert (r.n_rows, r.n_cols, r.block_rows, r.block_cols, r.tile_nnz) == \
        (t.n_rows, t.n_cols, t.block_rows, t.block_cols, t.tile_nnz)
    # rb_ptr: each row block's tiles are the contiguous range it names
    rb = t.tile_rb.long()
    ptr = t.rb_ptr.long()
    assert ptr[0] == 0 and ptr[-1] == t.n_tiles
    assert torch.equal(rb, torch.repeat_interleave(
        torch.arange(t.n_row_blocks), ptr[1:] - ptr[:-1]))


@pytest.mark.parametrize("scale,ef,seed,weighted", [
    (6, 2, 1, True), (8, 8, 3, True), (10, 16, 7, True), (7, 4, 2, False)])
def test_rmat_csr_byte_equal(scale, ef, seed, weighted):
    r = RG.rmat(scale, ef, seed=seed, weighted=weighted)
    t = TG.rmat(scale, ef, seed=seed, weighted=weighted, device="cpu")
    _eq_csr(r, t)
    _eq(r.row_ids(), t.row_ids())
    _eq(r.degrees(), t.degrees())
    _eq_csr(r.transpose(), t.transpose())
    assert t.nnz == r.nnz


def test_uniform_graph_and_dense():
    r = RG.uniform_random_graph(150, 4, seed=5)
    t = TG.uniform_random_graph(150, 4, seed=5, device="cpu")
    _eq_csr(r, t)
    _eq(r.to_dense(), t.to_dense())


def test_from_coo_sums_duplicate_runs_in_input_order():
    rng = np.random.default_rng(0)
    rows = np.concatenate([rng.integers(0, 20, 400), np.full(50, 3)])
    cols = np.concatenate([rng.integers(0, 30, 400), np.full(50, 7)])
    # magnitudes spread over 12 decades, so the order of addition matters
    vals = (rng.random(450) * 10.0 ** rng.integers(-6, 6, 450)).astype(
        np.float32)
    for dup in (False, True):
        r = RG.CSR.from_coo(rows, cols, vals, 20, 30, sum_duplicates=dup)
        t = TG.CSR.from_coo(rows, cols, vals, 20, 30, sum_duplicates=dup,
                            device="cpu")
        _eq_csr(r, t)
    r = RG.CSR.from_coo(rows, cols, None, 20, 30, sum_duplicates=True)
    t = TG.CSR.from_coo(rows, cols, None, 20, 30, sum_duplicates=True,
                        device="cpu")
    _eq_csr(r, t)


@pytest.mark.parametrize("geom", GEOMS)
def test_to_bbcsr_byte_equal(geom):
    br, bc, tn = geom
    r = RG.rmat(8, 8, seed=5)
    t = TG.rmat(8, 8, seed=5, device="cpu")
    for rg, tg in ((r, t), (r.transpose(), t.transpose())):
        _eq_bb(RG.to_bbcsr(rg, block_rows=br, block_cols=bc, tile_nnz=tn),
               TG.to_bbcsr(tg, block_rows=br, block_cols=bc, tile_nnz=tn))


def test_to_bbcsr_empty_row_blocks_and_empty_graph():
    # edges only in rows 0-7 and 40-47: row blocks 1-4 and 6-7 are empty
    rng = np.random.default_rng(1)
    rows = np.concatenate([rng.integers(0, 8, 60), rng.integers(40, 48, 60)])
    cols = rng.integers(0, 64, 120)
    vals = rng.random(120).astype(np.float32)
    r = RG.CSR.from_coo(rows, cols, vals, 64, 64, sum_duplicates=True)
    t = TG.CSR.from_coo(rows, cols, vals, 64, 64, sum_duplicates=True,
                        device="cpu")
    for br, bc, tn in ((8, 16, 4), (8, 64, 32), (16, 8, 8)):
        rb = RG.to_bbcsr(r, block_rows=br, block_cols=bc, tile_nnz=tn)
        _eq_bb(rb, TG.to_bbcsr(t, block_rows=br, block_cols=bc, tile_nnz=tn))
        assert int((np.asarray(rb.tile_cnt) == 0).sum()) >= 2
    z = np.zeros(0, np.int64)
    r0 = RG.CSR.from_coo(z, z, np.zeros(0, np.float32), 20, 20)
    t0 = TG.CSR.from_coo(z, z, np.zeros(0, np.float32), 20, 20, device="cpu")
    _eq_bb(RG.to_bbcsr(r0, block_rows=8, block_cols=8, tile_nnz=4),
           TG.to_bbcsr(t0, block_rows=8, block_cols=8, tile_nnz=4))


def test_converters_round_trip():
    r = RG.rmat(7, 8, seed=11)
    t = TG.csr_from_numpy(np.asarray(r.indptr), np.asarray(r.indices),
                          np.asarray(r.values), r.n_rows, r.n_cols,
                          device="cpu")
    _eq_csr(r, t)
    rb = RG.to_bbcsr(r, block_rows=32, block_cols=32, tile_nnz=64)
    fields = {f: np.asarray(getattr(rb, f)) for f in BB_FIELDS}
    fields.update(n_rows=rb.n_rows, n_cols=rb.n_cols,
                  block_rows=rb.block_rows, block_cols=rb.block_cols,
                  tile_nnz=rb.tile_nnz)
    tb = TG.bbcsr_from_numpy(fields, device="cpu")
    _eq_bb(rb, tb)
    built = TG.to_bbcsr(t, block_rows=32, block_cols=32, tile_nnz=64)
    assert torch.equal(built.rb_ptr, tb.rb_ptr)


@pytest.mark.parametrize("k", [None, 3])
def test_to_padded_ell_byte_equal(k):
    r = RG.rmat(7, 4, seed=2)
    t = TG.rmat(7, 4, seed=2, device="cpu")
    for a, b in zip(RG.to_padded_ell(r, k), TG.to_padded_ell(t, k)):
        _eq(a, b)


@pytest.mark.parametrize("unit,combine", [(False, "add"), (True, "add"),
                                          (False, "min")])
def test_build_pull_operand_byte_equal(unit, combine):
    r = RG.rmat(8, 8, seed=4)
    t = TG.rmat(8, 8, seed=4, device="cpu")
    geo = dict(block_rows=32, block_cols=64, tile_nnz=64)
    _eq_bb(RE.build_pull_operand(r, unit_values=unit, combine=combine, **geo),
           TE.build_pull_operand(t, unit_values=unit, combine=combine, **geo))
    frontier = np.zeros(r.n_rows, np.int32)
    frontier[[3, 77, 200]] = 1
    rb = RE.build_pull_operand(r, combine=combine, **geo)
    tb = TE.build_pull_operand(t, combine=combine, **geo)
    _eq(RE.tile_active(rb, jnp.asarray(frontier)),
        TE.tile_active(tb, torch.from_numpy(frontier)))


# tiles of the port's own kernels, not the reference's TPU tiles
PORT_TILES = ("kernels.segment_sum.block_n",
              "kernels.flash_attention.block_q",
              "kernels.flash_attention.block_k")


def test_tune_defaults_are_the_reference_defaults(tmp_path):
    from repro_torch.kernels import flash_attention as TFA
    no_file = str(tmp_path / "absent.json")     # no entry: the defaults
    for name, value in TT.DEFAULTS.items():
        assert name in REF_DEFAULTS
        assert TT.resolve(name, path=no_file) == value
        if name not in PORT_TILES:
            assert REF_DEFAULTS[name] == value
    assert TT.DEFAULTS["kernels.flash_attention.block_q"] in TFA.BLOCK_Q
    assert TT.DEFAULTS["kernels.flash_attention.block_k"] in TFA.BLOCK_K
    assert TT.DEFAULTS["kernels.segment_sum.block_n"] >= 1
    assert TT.resolve("kernels.bbcsr_add.tile_nnz", 128) == 128
    with pytest.raises(KeyError):
        TT.resolve("kernels.nope.block_rows")


def test_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros(1, np.int64)
    with pytest.raises(RuntimeError, match="CUDA"):
        TG.rmat(4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TG.uniform_random_graph(8, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TG.CSR.from_coo(z, z, None, 2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TG.csr_from_numpy(np.zeros(3, np.int32), np.zeros(0, np.int32), None,
                          2, 2)


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
