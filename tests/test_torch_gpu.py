"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: each test skips without a CUDA device (decided inside the
fixture, never at import).  Run on a machine with a card with
``python -m pytest -m gpu tests/test_torch_gpu.py``.  Imports only the port,
so it runs where JAX is not installed.
"""
import pytest
import torch

from repro_torch.core import engine, rmat
from repro_torch.core.algorithms import bfs, sssp, sssp_program
from repro_torch.kernels import ref
from repro_torch.kernels import spmv_dma as K

pytestmark = pytest.mark.gpu
GEOMS = [(256, 512, 512), (64, 128, 64), (32, 32, 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(bb, n, combine, frac, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    frontier = (torch.rand(n, device="cuda", generator=gen) < frac).to(
        torch.int32)
    ident = ref.combine_identity(combine)
    x = torch.where(frontier > 0, torch.rand(n, device="cuda", generator=gen),
                    ident)
    return x, engine.tile_active(bb, frontier)


@pytest.mark.parametrize("geom", GEOMS)
def test_spmv_kernel_matches_plain(cuda, geom):
    br, bc, tn = geom
    g = rmat(12, 16, seed=3)
    bb = engine.build_pull_operand(g, block_rows=br, block_cols=bc,
                                   tile_nnz=tn)
    x = torch.rand(g.n_rows, device=cuda)
    before = K.LAUNCHES["spmv_bbcsr"]
    got = K.spmv_bbcsr_kernel_call(bb, x)
    torch.cuda.synchronize()
    assert K.LAUNCHES["spmv_bbcsr"] == before + 1
    torch.testing.assert_close(got, ref.spmv_bbcsr_ref(bb, x), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("combine", ["add", "min", "max"])
@pytest.mark.parametrize("geom", GEOMS)
def test_spmspv_kernel_matches_plain(cuda, geom, combine):
    br, bc, tn = geom
    g = rmat(12, 16, seed=4)
    bb = engine.build_pull_operand(g, combine=combine, block_rows=br,
                                   block_cols=bc, tile_nnz=tn)
    for frac in (0.0, 0.002, 0.05, 1.0):
        x, act = _inputs(bb, g.n_rows, combine, frac, seed=int(frac * 1e3))
        got = K.spmspv_bbcsr_kernel_call(bb, x, act, combine=combine)
        want = ref.spmspv_bbcsr_ref(bb, x, act, combine=combine)
        torch.cuda.synchronize()
        if combine == "add":
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(got, want)


def test_kernel_paths_match_plain_engine(cuda):
    g = rmat(12, 16, seed=5)
    bb_u = engine.build_pull_operand(g, unit_values=True)
    assert torch.equal(bfs(g, 0, kernel_bb=bb_u), bfs(g, 0))
    bb_m = engine.build_pull_operand(g, combine="min")
    n, delta = g.n_rows, 0.25
    dist0 = torch.full((n,), float("inf"), device=cuda)
    dist0[0] = 0.0
    pend0 = torch.zeros(n, dtype=torch.bool, device=cuda)
    pend0[0] = True
    f0 = torch.zeros(n, dtype=torch.int32, device=cuda)
    f0[0] = 1
    state0 = {"dist": dist0, "pending": pend0,
              "bound": torch.tensor(delta, device=cuda)}
    st, stats = engine.run(g, sssp_program(delta), state0, f0,
                           max_iters=4 * n, kernel_bb=bb_m, return_stats=True)
    want, want_stats = sssp(g, 0, delta=delta, return_stats=True)
    assert torch.equal(st["dist"], want) and stats == want_stats


def test_wrappers_reject_bad_operands(cuda):
    g = rmat(8, 8, seed=6)
    bb = engine.build_pull_operand(g, block_rows=32, block_cols=32,
                                   tile_nnz=64)
    x = torch.rand(g.n_rows, device=cuda)
    with pytest.raises(ValueError):
        K.spmv_bbcsr_kernel_call(bb, x.cpu())
    with pytest.raises(ValueError):
        K.spmspv_bbcsr_kernel_call(
            bb, x, torch.ones(bb.n_tiles, dtype=torch.int64, device=cuda))


@pytest.mark.parametrize("kernel", [False, True])
def test_engine_reads_the_device_once_per_level(cuda, kernel):
    """The loop's one device-to-host read per level (plus the final one that
    sees an empty frontier) is the only synchronisation of a run."""
    import warnings

    from repro_torch.core.algorithms import bfs_program
    g = rmat(12, 16, seed=7)
    bb = engine.build_pull_operand(g, unit_values=True) if kernel else None
    n = g.n_rows
    level0 = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    level0[0] = 0
    f0 = torch.zeros(n, dtype=torch.int32, device=cuda)
    f0[0] = 1
    if kernel:   # the operand check reads the device once, before the loop
        engine._check_kernel_operand(bfs_program(), bb)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, stats = engine._core_loop(
                engine._local_core(g, bfs_program(), mode="auto",
                                   C=max(1, n // 32), kernel_bb=bb),
                {"level": level0}, f0, max_iters=n)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # one "called a synchronizing CUDA operation" warning per sync (the
    # mode also warns once that it is a prototype; that one is not a sync)
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert stats["pushes"] > 0 and stats["pulls"] > 0
    assert len(syncs) == stats["iters"] + 1, [str(w.message) for w in syncs]
