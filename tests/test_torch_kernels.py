"""Port parity: the plain versions of the BBCSR kernels (what the port's
wrappers compute on CPU tensors) against the reference's Pallas kernels run
in interpret mode through ``repro.kernels.ops``.

'add' within rtol/atol 1e-5 (the reference's kernel-vs-oracle tolerance:
the two sum in different orders); min/max exact.  The operands hold
inactive tiles and all-padding tiles.  Also the local offload ops.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as RE
from repro.core import graph as RG
from repro.core import offload as RO
from repro.kernels import ops as rops
from repro_torch.core import engine as TE
from repro_torch.core import graph as TG
from repro_torch.core import offload as TO
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spmv_dma as TK
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

BB_FIELDS = ("rows_local", "cols_local", "vals", "tile_rb", "tile_cb",
             "tile_init", "tile_cnt")
RNG = np.random.default_rng(42)


def port_bb(bb):
    fields = {f: np.asarray(getattr(bb, f)) for f in BB_FIELDS}
    fields.update(n_rows=bb.n_rows, n_cols=bb.n_cols,
                  block_rows=bb.block_rows, block_cols=bb.block_cols,
                  tile_nnz=bb.tile_nnz)
    return TG.bbcsr_from_numpy(fields, device="cpu")


def _gapped_graph():
    """Rows 8-39 and 48-63 hold no edges: empty row blocks get all-padding
    tiles; skewed rows spill into several tiles per bucket."""
    rows = np.concatenate([RNG.integers(0, 8, 300), RNG.integers(40, 48, 80)])
    cols = RNG.integers(0, 64, 380)
    vals = RNG.random(380).astype(np.float32)
    return RG.CSR.from_coo(rows, cols, vals, 64, 64, sum_duplicates=True)


CASES = [("rmat7", (32, 64, 64)), ("rmat8", (16, 32, 32)),
         ("gapped", (8, 16, 8))]


def _graph(name):
    if name == "gapped":
        return _gapped_graph()
    return RG.rmat(int(name[-1]), 8, seed=int(name[-1]))


@pytest.mark.parametrize("name,geom", CASES)
def test_spmv_plain_matches_reference_kernel(name, geom):
    br, bc, tn = geom
    bb = RG.to_bbcsr(_graph(name), block_rows=br, block_cols=bc, tile_nnz=tn)
    x = RNG.random(bb.n_cols).astype(np.float32)
    want = np.asarray(rops.spmv_dma(bb, jnp.asarray(x)))
    got = tops.spmv_dma(port_bb(bb), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("combine", ["add", "min", "max"])
@pytest.mark.parametrize("name,geom", CASES)
def test_spmspv_plain_matches_reference_kernel(name, geom, combine):
    br, bc, tn = geom
    g = _graph(name)
    bb = RE.build_pull_operand(g, combine=combine, block_rows=br,
                               block_cols=bc, tile_nnz=tn)
    tb = port_bb(bb)
    n = g.n_rows
    ident = {"add": 0.0, "min": np.inf, "max": -np.inf}[combine]
    for frac in (0.0, 0.03, 1.0):            # none / few / all tiles active
        frontier = (RNG.random(n) < frac).astype(np.int32)
        tact = RE.tile_active(bb, jnp.asarray(frontier))
        ttact = TE.tile_active(tb, torch.from_numpy(frontier))
        np.testing.assert_array_equal(np.asarray(tact), ttact.numpy())
        x = np.where(frontier > 0, RNG.random(n), ident).astype(np.float32)
        want = np.asarray(rops.spmspv_dma(bb, jnp.asarray(x), tact,
                                          combine=combine))
        got = tops.spmspv_dma(tb, torch.from_numpy(x), ttact,
                              combine=combine).numpy()
        if combine == "add":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)


def test_cpu_wrappers_take_plain_version_and_count_nothing():
    g = _gapped_graph()
    tb = TE.build_pull_operand(
        TG.csr_from_numpy(np.asarray(g.indptr), np.asarray(g.indices),
                          np.asarray(g.values), 64, 64, device="cpu"),
        block_rows=8, block_cols=16, tile_nnz=8)
    x = torch.from_numpy(RNG.random(64).astype(np.float32))
    before = dict(TK.LAUNCHES)
    y = TK.spmv_bbcsr_kernel_call(tb, x)
    act = torch.ones(tb.n_tiles, dtype=torch.int32)
    y2 = TK.spmspv_bbcsr_kernel_call(tb, x, act, combine="add")
    torch.testing.assert_close(y, y2, rtol=1e-6, atol=1e-6)
    assert TK.LAUNCHES == before
    with pytest.raises(ValueError):
        TK.spmspv_bbcsr_kernel_call(tb, x, act, combine="mul")


def test_dma_gather_and_scatter_add_match_reference():
    table = RNG.random((10, 3)).astype(np.float32)
    idx = np.array([[0, 9, -1], [10, 4, 4]], np.int32)
    want = np.asarray(RO.dma_gather(jnp.asarray(table), jnp.asarray(idx),
                                    fill=-2.0))
    got = TO.dma_gather(torch.from_numpy(table), torch.from_numpy(idx),
                        fill=-2.0).numpy()
    np.testing.assert_array_equal(got, want)
    vals = RNG.random((2, 3)).astype(np.float32)
    dest = np.zeros(10, np.float32)
    want = np.asarray(RO.dma_scatter_add(jnp.asarray(dest), jnp.asarray(idx),
                                         jnp.asarray(vals)))
    got = TO.dma_scatter_add(torch.from_numpy(dest), torch.from_numpy(idx),
                             torch.from_numpy(vals)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
