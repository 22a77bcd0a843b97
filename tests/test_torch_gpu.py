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


def _hub_operand(geom, combine="add", n=6000, n_rows=None, seed=0):
    """A pull operand whose row 5 takes in-edges from every vertex, plus a
    few random edges: row block 0 holds several shares of live slots,
    whatever the geometry.  With ``n_rows`` the matrix has that many rows
    and only the first n / 2 carry edges, so the rest are all-padding row
    blocks and the last one is ragged."""
    import numpy as np

    from repro_torch.core.graph import CSR, to_bbcsr
    rng = np.random.default_rng(seed)
    n_rows = n_rows or n
    top = n_rows if n_rows == n else n // 2
    dst = np.concatenate([np.full(n, 5), rng.integers(0, top, 3 * n)])
    src = np.concatenate([np.arange(n), rng.integers(0, n, 3 * n)])
    vals = rng.random(dst.size).astype(np.float32) + 0.5
    a_t = CSR.from_coo(dst, src, vals, n_rows, n, sum_duplicates=True,
                       device="cuda")
    br, bc, tn = geom
    return to_bbcsr(a_t, block_rows=br, block_cols=bc, tile_nnz=tn)


def _heaviest_block(bb):
    slots = torch.zeros(bb.n_row_blocks, dtype=torch.int64, device="cuda")
    slots.index_add_(0, bb.tile_rb.long(), bb.tile_cnt.long())
    return int(slots.argmax()), int(slots.max())


def _held(got, want, combine):
    torch.cuda.synchronize()
    if combine == "add":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("frac", [None, 0.05])
@pytest.mark.parametrize("geom", GEOMS)
def test_plan_kernel_matches_plain(cuda, geom, frac):
    """The schedule built on the card equals its plain version."""
    br, bc, tn = geom
    bb = _hub_operand(geom)
    act = None
    if frac is not None:
        _, act = _inputs(bb, bb.n_cols, "add", frac, seed=2)
    got = K.plan(bb, act)
    bb_cpu = type(bb)(**{f: (v.cpu() if torch.is_tensor(v) else v)
                         for f, v in vars(bb).items()})
    want = K.plan(bb_cpu, None if act is None else act.cpu())
    n_list, n_chunks, _ = want.meta.tolist()
    assert got.meta.tolist() == want.meta.tolist()
    assert torch.equal(got.list_tile[:n_list].cpu(), want.list_tile)
    assert torch.equal(got.list_ptr[:n_list + 1].cpu(), want.list_ptr)
    assert torch.equal(got.chunk_first[:n_chunks + 1].cpu(),
                       want.chunk_first)
    assert torch.equal(got.rb_slot.cpu(), want.rb_slot)


@pytest.mark.parametrize("combine", ["add", "min", "max"])
@pytest.mark.parametrize("geom", GEOMS)
def test_skewed_operand_matches_plain(cuda, geom, combine):
    """A hub row block far heavier than one share: dense (SpMV, or every
    tile active), a sparse frontier, and only the hub block's tiles
    active."""
    bb = _hub_operand(geom, combine)
    b, slots = _heaviest_block(bb)
    assert slots > 2 * int(K.plan(bb).meta[2])
    n = bb.n_cols
    x, act = _inputs(bb, n, combine, 0.05, seed=9)
    xd = torch.rand(n, device=cuda)
    all_act = torch.ones(bb.n_tiles, dtype=torch.int32, device=cuda)
    hub_act = (bb.tile_rb == b).to(torch.int32)
    if combine == "add":
        _held(K.spmv_bbcsr_kernel_call(bb, xd), ref.spmv_bbcsr_ref(bb, xd),
              combine)
    for xs, a in ((xd, all_act), (x, act), (xd, hub_act)):
        _held(K.spmspv_bbcsr_kernel_call(bb, xs, a, combine=combine),
              ref.spmspv_bbcsr_ref(bb, xs, a, combine=combine), combine)


@pytest.mark.parametrize("geom", GEOMS)
def test_add_kernels_are_bit_reproducible(cuda, geom):
    """Two SpMV launches, and two SpMSpV 'add' launches, give equal bits
    (the sums run in a fixed order, no float atomics)."""
    for bb in (_hub_operand(geom),
               engine.build_pull_operand(rmat(12, 16, seed=8),
                                         block_rows=geom[0],
                                         block_cols=geom[1],
                                         tile_nnz=geom[2])):
        n = bb.n_cols
        x, act = _inputs(bb, n, "add", 0.2, seed=4)
        xd = torch.rand(n, device=cuda)
        assert torch.equal(K.spmv_bbcsr_kernel_call(bb, xd),
                           K.spmv_bbcsr_kernel_call(bb, xd))
        assert torch.equal(K.spmspv_bbcsr_kernel_call(bb, x, act),
                           K.spmspv_bbcsr_kernel_call(bb, x, act))


@pytest.mark.parametrize("combine", ["add", "min", "max"])
@pytest.mark.parametrize("geom", GEOMS)
def test_rows_no_live_slot_reaches_are_the_identity(cuda, geom, combine):
    """All-padding row blocks and a ragged last row block (n_rows no
    multiple of block_rows) come out as the combine identity."""
    br = geom[0]
    bb = _hub_operand(geom, combine, n=3000, n_rows=3000 + br * 7 + 3)
    assert bb.n_rows % br != 0
    ident = ref.combine_identity(combine)
    x = torch.rand(bb.n_cols, device=cuda)
    all_act = torch.ones(bb.n_tiles, dtype=torch.int32, device=cuda)
    got = K.spmspv_bbcsr_kernel_call(bb, x, all_act, combine=combine)
    _held(got, ref.spmspv_bbcsr_ref(bb, x, all_act, combine=combine),
          combine)
    assert got.shape == (bb.n_rows,)
    assert bool((got[1500:] == ident).all())
    if combine == "add":
        y = K.spmv_bbcsr_kernel_call(bb, x)
        _held(y, ref.spmv_bbcsr_ref(bb, x), combine)
        assert bool((y[1500:] == 0).all())
    none = torch.zeros(bb.n_tiles, dtype=torch.int32, device=cuda)
    assert bool((K.spmspv_bbcsr_kernel_call(bb, x, none, combine=combine)
                 == ident).all())


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


# -- the kernel entry point: segment sum, EmbeddingBag, flash attention ------

def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("d", [1, 8, 64, 200])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_segment_sum_kernel_matches_plain(cuda, d, order):
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum as SS
    gen = _gen(d)
    n, m = 20000, 700
    seg = torch.randint(-1, m + 3, (n,), device=cuda, generator=gen,
                        dtype=torch.int32)          # -1 and ids >= m drop
    if order == "sorted":
        seg = seg.sort().values
    data = torch.randn(n, d, device=cuda, generator=gen)
    want = ref.segment_sum_ref(data, seg, m)
    for block_n in (None, 1, 100, 4096):
        before = SS.LAUNCHES["segment_sum"]
        got = ops.segment_sum_sorted(data, seg, m, block_n=block_n)
        torch.cuda.synchronize()
        assert SS.LAUNCHES["segment_sum"] == before + 1
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [1, 4, 11, 16, 33, 64, 200])
@pytest.mark.parametrize("weighted,mode", [(False, "sum"), (True, "sum"),
                                           (False, "mean"), (True, "mean")])
def test_embedding_bag_kernel_matches_plain(cuda, d, weighted, mode):
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.kernels import ops
    gen = _gen(d)
    V, n, n_bags = 5000, 30000, 1500
    table = torch.randn(V, d, device=cuda, generator=gen)
    idx = torch.randint(-1, V + 2, (n,), device=cuda, generator=gen,
                        dtype=torch.int32)           # -1 and >= V add 0
    bag = torch.randint(0, n_bags, (n,), device=cuda, generator=gen,
                        dtype=torch.int32)
    bag[bag % 7 == 3] -= 1                            # some bags empty
    w = torch.rand(n, device=cuda, generator=gen) if weighted else None
    want = ref.embedding_bag_ref(table, idx, bag, n_bags, w, mode)
    before = EB.LAUNCHES["embedding_bag"]
    got = ops.embedding_bag(table, idx, bag, n_bags, w, mode)
    order = bag.sort(stable=True).indices
    pre = ops.embedding_bag(table, idx[order], bag[order], n_bags,
                            None if w is None else w[order], mode,
                            presorted=True)
    torch.cuda.synchronize()
    assert EB.LAUNCHES["embedding_bag"] == before + 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(pre, want, rtol=1e-5, atol=1e-5)
    # stream order is fixed: a second run is bit-identical
    assert torch.equal(pre, ops.embedding_bag(
        table, idx[order], bag[order], n_bags,
        None if w is None else w[order], mode, presorted=True))


def test_embedding_bag_long_bags_within_summation_bound(cuda):
    """Bags of about 4,250 lookups: each bag's f32 sum in stream order is
    within the recursive-summation bound, (n + 2) 2^-24 sum |x|, of the
    float64 plain version, in 'sum' and 'mean' mode.  At this length sums
    of magnitude ~65 differ from the plain version by more than rtol /
    atol 1e-5 on some elements, and means, divided by the bag's length, do
    not; the test prints both verdicts."""
    from repro_torch.kernels import ops
    gen = _gen(500)
    V, n, n_bags, d = 5000, 34000, 8, 16
    table = torch.randn(V, d, device=cuda, generator=gen)
    idx = torch.randint(0, V, (n,), device=cuda, generator=gen,
                        dtype=torch.int32)
    bag = torch.randint(0, n_bags, (n,), device=cuda, generator=gen,
                        dtype=torch.int32).sort().values
    length = torch.bincount(bag.long(), minlength=n_bags).double()[:, None]
    abs_sum = ref.embedding_bag_ref(table.abs(), idx, bag, n_bags).double()
    for mode, scale in (("sum", 1.0), ("mean", 1.0 / length)):
        got = ops.embedding_bag(table, idx, bag, n_bags, mode=mode)
        want = ref.embedding_bag_ref(table, idx, bag, n_bags, mode=mode)
        err = (got.double() - want.double()).abs()
        bound = 1.01 * (length + 2) * 2.0 ** -24 * abs_sum * scale
        print(f"embedding_bag {mode}, bags of {int(length.min())}-"
              f"{int(length.max())}: max |kernel - plain| {float(err.max())!r}"
              f", largest share of the bound {float((err / bound).max())!r}, "
              f"within rtol/atol 1e-5: "
              f"{torch.allclose(got, want, rtol=1e-5, atol=1e-5)}")
        assert bool((err <= bound).all())


FA_CASES = [  # B, Hq, Hkv, Sq, Skv, causal, window
    (1, 2, 2, 64, 64, True, None), (2, 8, 2, 100, 100, True, None),
    (1, 8, 1, 64, 64, True, 33), (2, 4, 4, 1, 130, True, None),
    (3, 10, 2, 1, 77, True, 20), (1, 4, 2, 37, 100, True, None),
    (1, 4, 2, 50, 70, False, None), (1, 6, 3, 90, 60, False, 17),
    (1, 4, 1, 200, 200, True, 1)]


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, D, dtype):
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    tol = 2e-4 if dtype == torch.float32 else 5e-2
    gen = _gen(D)
    for i, (B, Hq, Hkv, Sq, Skv, causal, window) in enumerate(FA_CASES):
        q = torch.randn(B, Hq, Sq, D, device=cuda, generator=gen).to(dtype)
        k = torch.randn(B, Hkv, Skv, D, device=cuda, generator=gen).to(dtype)
        v = torch.randn(B, Hkv, Skv, D, device=cuda, generator=gen).to(dtype)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        bq, bk = FA.BLOCK_Q[i % 4], FA.BLOCK_K[i % 2]
        before = FA.LAUNCHES["flash_attention"]
        got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  block_q=bq, block_k=bk)
        torch.cuda.synchronize()
        assert FA.LAUNCHES["flash_attention"] == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=lambda m: f"case {i}: {m}")
        if dtype == torch.bfloat16:
            # per row: bf16 probabilities and output, 2^-8 relative each
            row = (got.float() - want.float()).norm(dim=-1) / \
                want.float().norm(dim=-1).clamp_min(1e-30)
            assert float(row.max()) <= 1e-2, f"case {i}: row {row.max()}"


def test_flash_attention_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import ops
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 or f32"):
        ops.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="block_q"):
        ops.flash_attention(q, q, q, block_q=1)
