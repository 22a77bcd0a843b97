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


def _csr_case(cuda, ids, gathered, d, seed, n_seg=3000, e=60_000):
    """(table, offsets, rows) of B4's CSR form: a plan of sorted, random
    or hub-heavy segment ids (a tenth -1; 'hub': two rows of 15,000 and
    8,000 entries), the identity rows or rows gathered from a table of
    2,000 rows with a few ids outside it."""
    from repro_torch.kernels import segment_sum as SS
    gen = _gen(seed)
    seg = torch.randint(0, n_seg, (e,), device=cuda, generator=gen,
                        dtype=torch.int32)
    if ids == "hub":
        seg[:15_000], seg[20_000:28_000] = 17, n_seg - 1
        seg = seg[torch.randperm(e, device=cuda, generator=gen)]
    seg[torch.rand(e, device=cuda, generator=gen) < 0.1] = -1
    if ids == "sorted":
        seg = torch.cat([seg[seg >= 0].sort().values, seg[seg < 0]])
    plan = SS.SegmentPlan(seg, n_seg)
    assert (plan.perm is None) == (ids == "sorted")
    if not gathered:
        table = torch.randn(e, d, device=cuda, generator=gen)
        return table, plan.offsets, plan.perm
    table = torch.randn(2000, d, device=cuda, generator=gen)
    src = torch.randint(-5, 2005, (e,), device=cuda, generator=gen,
                        dtype=torch.int32)
    rows = src if plan.perm is None else src[plan.perm.long()]
    return table, plan.offsets, rows


def _within_sum_bound(got, want, table, offsets, rows):
    """|got - want| within the error bound of an f32 sum of each row's L
    terms in any order, L 2^-24 sum |x| (a hub row of 13,500 terms drifts
    by 1e-4 from the float64 sum), plus 1e-6."""
    length = (offsets[1:] - offsets[:-1]).to(torch.float32)[:, None]
    mass = ref.segment_sum_csr_ref(table.abs(), offsets, rows)
    return bool(((got - want).abs() <= length * 2.0 ** -24 * mass * 1.01
                 + 1e-6).all())


@pytest.mark.parametrize("d", [16, 64, 100])
@pytest.mark.parametrize("ids", ["sorted", "random", "hub"])
@pytest.mark.parametrize("gathered", [False, True])
def test_segment_sum_csr_kernel_matches_plain(cuda, d, ids, gathered):
    """B4's CSR kernel: the bits of its order's mirror
    (``ref.segment_sum_pieces_ref``) and within an f32 sum's error bound of
    the float64 plain version, at the tuned block_n and at 256 (hub rows
    split)."""
    from repro_torch import tune
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum as SS
    table, offsets, rows = _csr_case(cuda, ids, gathered, d, d)
    want = ref.segment_sum_csr_ref(table, offsets, rows)
    for block_n in (None, 256):
        before = SS.LAUNCHES["segment_sum"]
        got = ops.segment_sum_csr(table, offsets, rows, block_n=block_n)
        torch.cuda.synchronize()
        assert SS.LAUNCHES["segment_sum"] == before + 1
        bn = int(tune.resolve("kernels.segment_sum.block_n", block_n,
                              n=offsets.numel() - 1, device=table.device))
        torch.testing.assert_close(got, ref.segment_sum_pieces_ref(
            table, offsets, rows, block_n=bn), rtol=0, atol=0)
        assert _within_sum_bound(got, want, table, offsets, rows)


def test_segment_sum_csr_splits_rows_bit_reproducibly(cuda):
    """Hub rows cut into pieces: the split path is taken (the kernel's rule
    names split rows) and right (the bits of its order's mirror, and within
    an f32 sum's error bound of the float64 sum); two launches give equal
    bits; a planted fault (the hub row's largest entry dropped) fails the
    bit check and the 1e-4 one of ``chip_smoke.py``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum as SS
    table, offsets, rows = _csr_case(cuda, "hub", True, 64, 5)
    assert SS.split_rows(offsets, 512) >= 2
    want = ref.segment_sum_csr_ref(table, offsets, rows)
    a = ops.segment_sum_csr(table, offsets, rows, block_n=512)
    b = ops.segment_sum_csr(table, offsets, rows, block_n=512)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert _within_sum_bound(a, want, table, offsets, rows)
    # the fault: the hub row's entry with the largest |x| dropped
    hub = int(torch.argmax(offsets[1:] - offsets[:-1]))
    lo, hi = int(offsets[hub]), int(offsets[hub + 1])
    ids = rows[lo:hi].long()
    size = torch.where((ids >= 0) & (ids < table.shape[0]),
                       table[ids.clamp(0, table.shape[0] - 1)].abs().amax(1),
                       0)
    faulty = rows.clone()
    faulty[lo + int(torch.argmax(size))] = -1
    bad = ops.segment_sum_csr(table, offsets, faulty, block_n=512)
    assert torch.equal(a, ref.segment_sum_pieces_ref(table, offsets, rows,
                                                      block_n=512))
    assert not torch.equal(bad, a)
    assert not torch.allclose(bad, want, rtol=1e-4, atol=1e-4)


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
    # the summation order is fixed: a second run is bit-identical
    assert torch.equal(pre, ops.embedding_bag(
        table, idx[order], bag[order], n_bags,
        None if w is None else w[order], mode, presorted=True))


def test_embedding_bag_long_bags_within_summation_bound(cuda):
    """Bags of about 4,250 lookups, each over some 9 chunks: each bag's
    f32 sum (stream order inside a chunk, then chunk order) is within the
    recursive-summation bound, (n + 2) 2^-24 sum |x|, of the
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


def _skewed_stream(cuda, gen, n_bags=3000, long_bag=100_000):
    """Bag ids sorted: one bag of long_bag lookups among bags of 1-3, about
    a fifth of the bags empty."""
    short = torch.randint(1, 4, (n_bags,), device=cuda, generator=gen)
    short[torch.rand(n_bags, device=cuda, generator=gen) < 0.2] = 0
    short[n_bags // 2] = long_bag
    return torch.repeat_interleave(
        torch.arange(n_bags, device=cuda, dtype=torch.int32), short), n_bags


def _held_with_long_bags(got, want, table, idx, bag, n_bags, w, mode):
    """Rows of bags up to 1,000 lookups within rtol / atol 1e-5 of the
    plain version, longer ones within the recursive-summation bound,
    (n + 2) 2^-24 sum |w x|, over the bag's weight sum W for 'mean'; twice
    that for a weighted mean, whose W carries the same bound."""
    length = torch.bincount(bag.long(), minlength=n_bags)
    long = length > 1000
    torch.testing.assert_close(got[~long], want[~long], rtol=1e-5,
                               atol=1e-5)
    wabs = None if w is None else w.abs()
    abs_sum = ref.embedding_bag_ref(table.abs(), idx, bag, n_bags, wabs)
    scale = 1.0
    if mode == "mean":
        scale = (1.0 if w is None else 2.0) / ref.embedding_bag_ref(
            torch.ones_like(table[:, :1]), idx, bag, n_bags, w).double()
    bound = 1.01 * (length[:, None] + 2) * 2.0 ** -24 * \
        abs_sum.double() * scale
    err = (got.double() - want.double()).abs()
    assert bool((err[long] <= bound[long]).all())


@pytest.mark.parametrize("weighted,mode", [(False, "sum"), (True, "mean")])
@pytest.mark.parametrize("presorted", [False, True])
def test_embedding_bag_skewed_bags_match_plain(cuda, presorted, weighted,
                                               mode):
    """One bag of 100,000 lookups (some 196 chunks) among bags of 1-3 and
    empty bags, sorted by the entry point or presorted: within tolerance of
    the plain version, and, presorted, the bits of the kernel's order
    (ref.embedding_bag_pieces_ref on the same stream)."""
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.kernels import ops
    gen = _gen(77)
    bag, n_bags = _skewed_stream(cuda, gen)
    n, V, d = bag.numel(), 20000, 11
    table = torch.randn(V, d, device=cuda, generator=gen)
    idx = torch.randint(-1, V, (n,), device=cuda, generator=gen,
                        dtype=torch.int32)
    w = torch.rand(n, device=cuda, generator=gen) if weighted else None
    if not presorted:       # the entry point sorts a shuffled stream
        perm = torch.randperm(n, device=cuda, generator=gen)
        idx, bag = idx[perm], bag[perm]
        w = None if w is None else w[perm]
    got = ops.embedding_bag(table, idx, bag, n_bags, w, mode,
                            presorted=presorted)
    want = ref.embedding_bag_ref(table, idx, bag, n_bags, w, mode)
    _held_with_long_bags(got, want, table, idx, bag, n_bags, w, mode)
    empty = torch.bincount(bag.long(), minlength=n_bags) == 0
    assert empty.any() and not got[empty].any()
    if presorted:
        mirror = ref.embedding_bag_pieces_ref(
            table, idx, bag, n_bags, EB.bag_pieces(bag), w, mode)
        assert torch.equal(got, mirror)


def test_embedding_bag_skewed_bags_give_equal_bits(cuda):
    """Two runs on the skewed stream, through the entry point's sort and
    presorted: equal bits each time."""
    from repro_torch.kernels import ops
    gen = _gen(78)
    bag, n_bags = _skewed_stream(cuda, gen)
    n = bag.numel()
    table = torch.randn(5000, 16, device=cuda, generator=gen)
    idx = torch.randint(0, 5000, (n,), device=cuda, generator=gen,
                        dtype=torch.int32)
    w = torch.rand(n, device=cuda, generator=gen)
    perm = torch.randperm(n, device=cuda, generator=gen)
    for mode in ("sum", "mean"):
        first = ops.embedding_bag(table, idx, bag, n_bags, w, mode,
                                  presorted=True)
        assert torch.equal(first, ops.embedding_bag(
            table, idx, bag, n_bags, w, mode, presorted=True))
        shuffled = ops.embedding_bag(table, idx[perm], bag[perm], n_bags,
                                     w[perm], mode)
        assert torch.equal(shuffled, ops.embedding_bag(
            table, idx[perm], bag[perm], n_bags, w[perm], mode))


@pytest.mark.parametrize("weighted,mode", [(False, "sum"), (True, "mean")])
def test_embedding_bag_zipf_ids_at_fm_width(cuda, weighted, mode):
    """fm's row width (d 11, rows 44 bytes, so 16-byte windows at every
    offset) and its ids: 39 fields, Zipf(1.2) ids in each, a bag per
    sample; 10% of ids -1 when weighted.  Within 1e-5 of the plain version
    and the bits of the kernel's order."""
    import numpy as np
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.kernels import ops
    fields, per_field, batch, d = 39, 20000, 4096, 11
    rng = np.random.default_rng(11)
    local = rng.zipf(1.2, size=(batch, fields)) % per_field
    ids = local + np.arange(fields)[None, :] * per_field
    idx = torch.from_numpy(ids.reshape(-1).astype(np.int32)).to(cuda)
    bag = torch.arange(batch, dtype=torch.int32,
                       device=cuda).repeat_interleave(fields)
    gen = _gen(11)
    table = torch.randn(fields * per_field, d, device=cuda, generator=gen)
    w = None
    if weighted:
        idx = torch.where(torch.rand(idx.numel(), device=cuda, generator=gen)
                          < 0.1, -1, idx)
        w = torch.rand(idx.numel(), device=cuda, generator=gen)
    got = ops.embedding_bag(table, idx, bag, batch, w, mode, presorted=True)
    torch.testing.assert_close(
        got, ref.embedding_bag_ref(table, idx, bag, batch, w, mode),
        rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ref.embedding_bag_pieces_ref(
        table, idx, bag, batch, EB.bag_pieces(bag), w, mode))


@pytest.mark.parametrize("d", [3, 11, 13, 16])
def test_embedding_bag_table_not_16_byte_aligned(cuda, d):
    """A table whose first float is not 16-byte aligned, and one whose last
    row ends inside a float4 (V d not a multiple of 4, the last row looked
    up): the scalar loads give the same bits as the aligned float4 ones."""
    from repro_torch.kernels import ops
    gen = _gen(d + 40)
    V, n, n_bags = 4001, 20000, 700
    flat = torch.randn(V * d + 1, device=cuda, generator=gen)
    shifted = flat[1:].view(V, d)                  # 4 bytes past alignment
    aligned = shifted.clone()
    idx = torch.randint(-1, V, (n,), device=cuda, generator=gen,
                        dtype=torch.int32)
    idx[::50] = V - 1
    bag = torch.randint(0, n_bags, (n,), device=cuda, generator=gen,
                        dtype=torch.int32).sort().values
    assert shifted.data_ptr() % 16 != 0 and aligned.data_ptr() % 16 == 0
    got = ops.embedding_bag(shifted, idx, bag, n_bags, presorted=True)
    assert torch.equal(got, ops.embedding_bag(aligned, idx, bag, n_bags,
                                              presorted=True))
    torch.testing.assert_close(
        got, ref.embedding_bag_ref(aligned, idx, bag, n_bags), rtol=1e-5,
        atol=1e-5)

FA_CASES = [  # B, Hq, Hkv, Sq, Skv, causal, window
    (1, 2, 2, 64, 64, True, None), (2, 8, 2, 100, 100, True, None),
    (1, 8, 1, 64, 64, True, 33), (2, 4, 4, 1, 130, True, None),
    (3, 10, 2, 1, 77, True, 20), (1, 4, 2, 37, 100, True, None),
    (1, 4, 2, 50, 70, False, None), (1, 6, 3, 90, 60, False, 17),
    (1, 4, 1, 200, 200, True, 1),
    # ragged against the wgmma kernel's 128-wide tiles; Hq / Hkv = 5 as in
    # qwen3-14b; a window that cuts a key block; a batch-1 decode long
    # enough to split its keys
    (1, 10, 2, 200, 130, False, None), (2, 10, 2, 130, 200, True, None),
    (1, 5, 1, 300, 700, True, 150), (1, 40, 8, 1, 4096 + 77, True, None)]


def _expected_paths(dtype, D, B, Hq, Hkv, Sq, Skv, causal, window, bq, bk):
    """(wgmma launches, split launches) the dispatch rule gives one call."""
    from repro_torch.kernels import flash_attention as FA
    if FA.path(dtype, D, Sq) == "wgmma":
        return 1, 0
    window = None if window is None else min(window, Skv)
    splits = FA.split_plan(B, Hkv, Sq, Skv, Hq // Hkv, bq, bk, causal, window,
                           FA._sm_count(torch.cuda.current_device()))
    return 0, int(splits > 1)


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
        FA.reset_launches()
        got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  block_q=bq, block_k=bk)
        torch.cuda.synchronize()
        wg, split = _expected_paths(dtype, D, B, Hq, Hkv, Sq, Skv, causal,
                                    window, bq, bk)
        assert FA.LAUNCHES == {"flash_attention": 1,
                               "flash_attention_wgmma": wg,
                               "flash_attention_split": split}, f"case {i}"
        if Skv > 4096:                  # the long batch-1 decode splits
            assert split == 1, f"case {i}"
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=lambda m: f"case {i}: {m}")
        if dtype == torch.bfloat16:
            # per row: bf16 probabilities and output, 2^-8 relative each
            row = (got.float() - want.float()).norm(dim=-1) / \
                want.float().norm(dim=-1).clamp_min(1e-30)
            assert float(row.max()) <= 1e-2, f"case {i}: row {row.max()}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_split_decode_gives_equal_bits(cuda, dtype):
    """qwen3-14b's batch-1 decode over a 32,768-key cache: its keys split,
    and the pieces merge in split order, so two launches agree bit for
    bit."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    gen = _gen(14)
    q = torch.randn(1, 40, 1, 128, device=cuda, generator=gen).to(dtype)
    k = torch.randn(1, 8, 32768, 128, device=cuda, generator=gen).to(dtype)
    v = torch.randn(1, 8, 32768, 128, device=cuda, generator=gen).to(dtype)
    FA.reset_launches()
    first = ops.flash_attention(q, k, v)
    second = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention_split"] == 2
    assert torch.equal(first, second)
    tol = 2e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(first.float(), ref.flash_attention_ref(
        q, k, v).float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [
    (1, 10, 2, 200, 200, True, None), (2, 8, 2, 1000, 1000, True, 300),
    (1, 5, 1, 130, 640, True, None), (1, 4, 2, 256, 256, False, None)])
def test_flash_attention_wgmma_matches_folded_kernel(cuda, shape):
    """The wgmma kernel against the folded mma.sync kernel on the same bf16
    inputs, per row within 1e-2 (both round the probabilities and the
    output to bf16, at other places)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    B, Hq, Hkv, Sq, Skv, causal, window = shape
    gen = _gen(Sq)
    q, k, v = (torch.randn(B, h, s, 128, device=cuda, generator=gen).to(
        torch.bfloat16) for h, s in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv)))
    FA.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert FA.LAUNCHES["flash_attention_wgmma"] == 1
    folded = torch.empty_like(q)
    _build.launch(FA._lib().flash_attention_fwd, q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), folded.data_ptr(), None, None,
                  B, Hq, Hkv, Sq, Skv, Skv, 128, int(causal), window or 0,
                  128 ** -0.5, 64, 64, 1, 1, what="flash_attention")
    torch.cuda.synchronize()
    row = (got.float() - folded.float()).norm(dim=-1) / \
        folded.float().norm(dim=-1).clamp_min(1e-30)
    assert float(row.max()) <= 1e-2, float(row.max())


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


@pytest.mark.parametrize("weighted,mode", [(False, "sum"), (True, "mean")])
@pytest.mark.parametrize("presorted", [False, True])
def test_embedding_bag_kernel_drops_bag_ids_out_of_range(cuda, presorted,
                                                         weighted, mode):
    """Bag ids -1 and >= n_bags give nothing on the card, as on the CPU."""
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.kernels import ops
    gen = _gen(31)
    V, n, n_bags, d = 1000, 4000, 50, 11
    table = torch.randn(V, d, device=cuda, generator=gen)
    idx = torch.randint(-1, V, (n,), device=cuda, generator=gen,
                        dtype=torch.int32)
    bag = torch.randint(-3, n_bags + 3, (n,), device=cuda, generator=gen,
                        dtype=torch.int32)
    if presorted:
        bag, order = torch.sort(bag, stable=True)
        idx = idx[order]
    w = torch.rand(n, device=cuda, generator=gen) if weighted else None
    before = EB.LAUNCHES["embedding_bag"]
    got = ops.embedding_bag(table, idx, bag, n_bags, w, mode,
                            presorted=presorted)
    torch.cuda.synchronize()
    assert EB.LAUNCHES["embedding_bag"] == before + 1
    on_cpu = ops.embedding_bag(table.cpu(), idx.cpu(), bag.cpu(), n_bags,
                               None if w is None else w.cpu(), mode,
                               presorted=presorted)
    torch.testing.assert_close(got.cpu(), on_cpu, rtol=1e-5, atol=1e-5)
    keep = (bag >= 0) & (bag < n_bags)
    torch.testing.assert_close(got, ref.embedding_bag_ref(
        table, idx[keep], bag[keep], n_bags,
        None if w is None else w[keep], mode), rtol=1e-5, atol=1e-5)


# -- batched lanes: segment_or, msbfs, sssp_batched, batched PPR -------------

@pytest.mark.parametrize("case", ["hub_sorted", "unsorted_w2", "all_bits",
                                  "empty"])
def test_segment_or_kernel_matches_plain(cuda, case):
    """Bit-equal to the plain version: a hub id taking 100k items (sorted,
    W 1), random ids with out-of-range ones and mostly-zero words (W 2),
    every word all 32 bits set (the sign bit too) on duplicate ids, and an
    empty stream (no launch)."""
    from repro_torch.kernels import segment_or as SO
    gen = _gen(21)
    n = 5000

    def rand_words(m, w):
        return torch.randint(-2**31, 2**31, (m, w), device=cuda,
                             generator=gen, dtype=torch.int32)

    if case == "hub_sorted":
        idx = torch.cat([torch.full((100_000,), 17, device=cuda),
                         torch.randint(0, n, (50_000,), device=cuda,
                                       generator=gen)]).sort().values
        words = rand_words(idx.numel(), 1)
    elif case == "unsorted_w2":
        idx = torch.randint(-3, n + 3, (60_000,), device=cuda, generator=gen)
        words = rand_words(idx.numel(), 2)
        words[torch.rand(idx.numel(), device=cuda, generator=gen) < 0.9] = 0
    elif case == "all_bits":
        idx = torch.randint(0, 64, (10_000,), device=cuda, generator=gen)
        words = torch.full((idx.numel(), 1), -1, dtype=torch.int32,
                           device=cuda)
    else:
        idx = torch.zeros(0, dtype=torch.int64, device=cuda)
        words = torch.zeros((0, 2), dtype=torch.int32, device=cuda)
    before = SO.LAUNCHES["segment_or"]
    got = SO.segment_or_kernel_call(idx.to(torch.int32), words, n)
    torch.cuda.synchronize()
    assert SO.LAUNCHES["segment_or"] == before + (case != "empty")
    assert got.dtype == torch.int32 and got.shape == (n, words.shape[1])
    assert torch.equal(got, ref.segment_or_ref(idx, words, n))
    if case == "all_bits":
        assert bool((got[:64] == -1).all()) and not bool(got[64:].any())


def test_batched_lanes_match_cpu(cuda):
    """msbfs (packed lanes, segment_or), sssp_batched (plain and B3 per
    lane) and batched PPR (B2 per lane) on the card against the same
    calls on the CPU; the kernels' launch counts move."""
    from repro_torch.core import csr_from_numpy
    from repro_torch.core.algorithms import (msbfs, ppr_batched, ppr_program,
                                             sssp_batched)
    from repro_torch.kernels import segment_or as SO
    g = rmat(12, 16, seed=5)
    c = csr_from_numpy(g.indptr.cpu().numpy(), g.indices.cpu().numpy(),
                       g.values.cpu().numpy(), g.n_rows, g.n_cols,
                       device="cpu")
    src = list(range(0, 64, 2)) + [0]          # 33 lanes, one duplicate
    before = SO.LAUNCHES["segment_or"]
    for mode in ("push", "pull", "auto"):
        lv, st = msbfs(g, src, mode=mode, return_stats=True)
        lv_c, st_c = msbfs(c, src, mode=mode, return_stats=True)
        assert torch.equal(lv.cpu(), lv_c) and st == st_c
    assert SO.LAUNCHES["segment_or"] > before
    delta = 0.25
    bb_m = engine.build_pull_operand(g, combine="min")
    before = K.LAUNCHES["spmspv_bbcsr_select"]
    for mode in ("push", "auto"):
        d_c, st_c = sssp_batched(c, src[:8], delta=delta, mode=mode,
                                 return_stats=True)
        for kernel in (None, bb_m):
            d, st = sssp_batched(g, src[:8], delta=delta, mode=mode,
                                 kernel_bb=kernel, return_stats=True)
            assert torch.equal(d.cpu(), d_c) and st == st_c
    assert K.LAUNCHES["spmspv_bbcsr_select"] > before
    bb_u = engine.build_pull_operand(g, unit_values=True)
    n, B = g.n_rows, 8
    r = torch.zeros((B, n), device=cuda)
    r[torch.arange(B), torch.tensor(src[:B])] = 1.0
    before = K.LAUNCHES["spmspv_bbcsr_add"]
    st = engine.run_batched(g, ppr_program(g, 0.85), {"x": r, "r": r},
                            torch.ones((B, n), dtype=torch.int32,
                                       device=cuda),
                            max_iters=20, mode="pull", kernel_bb=bb_u)
    torch.cuda.synchronize()
    assert K.LAUNCHES["spmspv_bbcsr_add"] == before + 20 * B
    torch.testing.assert_close(st["x"].cpu(), ppr_batched(c, src[:B]),
                               rtol=1e-5, atol=1e-5)


# -- tuning: the resolver, the mirror and the gate on the card -------------

def _same_knobs_on_both_backends(tmp_path, monkeypatch, scale):
    """Point the resolver at a file whose "cpu" and "cuda" entries at
    ``scale`` hold the committed CPU entry's knobs."""
    import importlib
    import json

    from repro_torch import tune
    resolve_mod = importlib.import_module("repro_torch.tune.resolve")
    params = tune.lookup("cpu", scale)["params"]
    path = tmp_path / "tuned.json"
    path.write_text(json.dumps({"version": 1, "entries": [
        {"backend": b, "scale": scale, "params": params}
        for b in ("cpu", "cuda")]}))
    monkeypatch.setattr(resolve_mod, "TUNED_PATH", str(path))


@pytest.mark.parametrize("block_rows", [32, 64, 128, 256, 512])
def test_smem_mirror_equals_the_library(cuda, block_rows):
    from repro_torch.tune import space
    assert K._lib().bbcsr_smem_bytes(block_rows) == \
        space.bbcsr_smem_bytes(block_rows)


def _geometry(bb):
    return {"block_rows": bb.block_rows, "block_cols": bb.block_cols,
            "tile_nnz": bb.tile_nnz}


def test_cuda_csr_resolves_the_card_entry(cuda):
    """At scale 14 the committed "cuda" entry at 16 and "cpu" entry at 12
    are both in the window: a CUDA graph builds its operands from the
    former, the same graph on the CPU from the latter, neither counted as
    a fallback."""
    from repro_torch import tune
    from repro_torch.obs import get_registry
    g = rmat(14, 8, seed=0)
    c = _cpu(g)
    counter = get_registry().counter("tune.autotune_fallback")
    before = counter.value
    for combine in ("add", "min"):
        fam = "bbcsr_min" if combine == "min" else "bbcsr_add"
        for graph, backend in ((g, "cuda"), (c, "cpu")):
            bb = engine.build_pull_operand(graph, combine=combine)
            params = tune.lookup(backend, 14)["params"]
            assert _geometry(bb) == {k: params[f"kernels.{fam}.{k}"]
                                     for k in _geometry(bb)}
            assert bb.vals.device.type == backend
    assert tune.lookup("cuda", 14)["scale"] == 16
    assert counter.value == before


@pytest.mark.parametrize("graph", ["probe", "chip_smoke"])
def test_admitted_add_geometries_give_default_bits(cuda, graph):
    """Every 'add' geometry the committed scale-16 sweep admitted gives the
    default geometry's SpMV bits at RMAT-16: on the sweep's probe and on
    chip_smoke's graph, which the gate never saw."""
    from repro_torch import tune
    from repro_torch.tune import space
    from repro_torch.tune.sweep import _inputs
    g = rmat(16, 8, seed=0) if graph == "probe" else rmat(16, 16, seed=7)
    entry = [e for e in tune.load_tuned()["entries"]
             if (e["backend"], e["scale"]) == ("cuda", 16)][0]
    admitted = [cfg for cfg, _ in
                entry["scores"]["kernels.bbcsr_add"]["candidates"]]
    default = space.kernel_grid("kernels.bbcsr_add")[0]
    assert admitted[0] == default and len(admitted) >= 2
    x, _ = _inputs(g.n_rows, "add", cuda)
    want = K.spmv_bbcsr_kernel_call(
        engine.build_pull_operand(g, **default), x)
    for cfg in admitted[1:]:
        got = K.spmv_bbcsr_kernel_call(engine.build_pull_operand(g, **cfg), x)
        assert torch.equal(got, want), cfg


# -- the local graph query service ------------------------------------------

class _TickClock:
    """Advances by a fixed tick on every read: both services see the same
    clock, so every stat (latency, qps) is comparable exactly."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _serve(g, queries, inserts):
    from repro_torch.core import GraphService
    svc = GraphService(g, batch_budget=8, clock=_TickClock())
    tickets = [svc.submit(q) for q in queries]
    svc.flush()
    out = [svc.result(t) for t in tickets]
    svc.apply_updates(inserts=inserts)
    tickets = [svc.submit(q) for q in queries]
    svc.flush()
    out += [svc.result(t) for t in tickets]
    return svc, out


def test_service_matches_cpu(cuda, tmp_path, monkeypatch):
    """One seeded mixed stream (all four kinds, repeats, an edge update in
    one partition between two passes) through a CUDA service and a CPU
    service on rmat(10): Reachability, Distance and NeighborSample draws
    (the keyed hash is device-independent) and the spliced CSR bit-equal,
    PPR within 1e-5, stats equal.  Each backend resolves its own tuned
    entry, so both read one file holding equal knobs for either."""
    import numpy as np
    from repro_torch.core import (Distance, NeighborSample, PPRTopK,
                                  Reachability, csr_from_numpy)
    _same_knobs_on_both_backends(tmp_path, monkeypatch, 10)
    g = rmat(10, 8, seed=3)
    c = csr_from_numpy(g.indptr.cpu().numpy(), g.indices.cpu().numpy(),
                       g.values.cpu().numpy(), g.n_rows, g.n_cols,
                       device="cpu")
    rng = np.random.default_rng(4)
    n = g.n_rows
    srcs = rng.integers(0, n, 10)
    kinds = [Reachability, Distance, PPRTopK, NeighborSample]
    queries = []
    for _ in range(60):
        k = kinds[int(rng.integers(4))]
        s = int(rng.choice(srcs))
        queries.append(k(s, int(rng.integers(n))) if k in kinds[:2] else
                       PPRTopK(s, k=int(rng.integers(1, 12))) if k is PPRTopK
                       else NeighborSample(int(rng.integers(n)),
                                           fanout=int(rng.integers(1, 4)),
                                           seed=int(rng.integers(3))))
    lo = 7 * (n // 8)
    inserts = (rng.integers(lo, n, 64), rng.integers(lo, n, 64),
               rng.random(64).astype(np.float32))
    svc_g, out_g = _serve(g, queries, inserts)
    svc_c, out_c = _serve(c, queries, inserts)
    assert svc_g.csr.device.type == "cuda"
    for f in ("indptr", "indices", "values"):
        assert torch.equal(getattr(svc_g.csr, f).cpu(), getattr(svc_c.csr, f))
    for q, a, b in zip(queries + queries, out_g, out_c):
        if isinstance(q, PPRTopK):
            np.testing.assert_allclose(a[1], b[1], rtol=1e-5, atol=1e-5)
            gaps = np.abs(np.diff(b[1])) > 1e-5
            clear = np.r_[gaps, True] & np.r_[True, gaps]
            np.testing.assert_array_equal(a[0][clear], b[0][clear])
        elif isinstance(q, NeighborSample):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert type(a) is type(b) and (a == b or a != a and b != b)
    assert svc_g.stats.as_dict() == svc_c.stats.as_dict()
    assert svc_g.stats.cache_hits > 0 and svc_g.stats.updates == 1


# -- structured combines: segment_mode, run_sum, LPA, Louvain, sampling ------

def _cpu(g):
    from repro_torch.core import csr_from_numpy
    return csr_from_numpy(g.indptr.cpu().numpy(), g.indices.cpu().numpy(),
                          None if g.values is None else g.values.cpu().numpy(),
                          g.n_rows, g.n_cols, device="cpu")


@pytest.mark.parametrize("case", ["hub_runs", "ties", "random", "empty"])
def test_segment_mode_kernel_matches_plain(cuda, case):
    """Bit-equal to the plain version on a (dst, label)-sorted stream: one
    hub destination taking 200k votes in a few long label runs, integer
    weights full of ties, random f32 weights with -inf items and ids out of
    range, and an empty stream (no launch)."""
    from repro_torch.core import offload
    from repro_torch.kernels import segment_mode as SM
    gen = _gen(31)
    n = 3000
    if case == "hub_runs":
        idx = torch.cat([torch.full((200_000,), 7, device=cuda),
                         torch.randint(0, n, (50_000,), device=cuda,
                                       generator=gen)])
        lab = torch.randint(0, 5, (idx.numel(),), device=cuda, generator=gen)
        w = torch.rand(idx.numel(), device=cuda, generator=gen)
    elif case == "ties":
        idx = torch.randint(0, n, (80_000,), device=cuda, generator=gen)
        lab = torch.randint(0, 40, (idx.numel(),), device=cuda,
                            generator=gen)
        w = torch.randint(0, 3, (idx.numel(),), device=cuda,
                          generator=gen).float()
    elif case == "random":
        idx = torch.randint(-3, n + 3, (80_000,), device=cuda, generator=gen)
        lab = torch.randint(-2, 2000, (idx.numel(),), device=cuda,
                            generator=gen)
        w = torch.rand(idx.numel(), device=cuda, generator=gen) * 1e3
        w[torch.rand(idx.numel(), device=cuda, generator=gen) < 0.01] = \
            float("-inf")
    else:
        idx = torch.zeros(0, dtype=torch.int64, device=cuda)
        lab, w = idx.clone(), torch.zeros(0, device=cuda)
    valid = (idx >= 0) & (idx < n) & (lab >= 0)
    key, order = torch.sort(
        (torch.where(valid, idx, n).long() << 32)
        | torch.where(valid, lab, offload.LABEL_PAD).long(), stable=True)
    sw = torch.where(valid[order], w[order], 0.0)
    before = SM.LAUNCHES["segment_mode"]
    got = SM.segment_mode_kernel_call(key >> 32, key & 0xFFFFFFFF, sw, n)
    torch.cuda.synchronize()
    assert SM.LAUNCHES["segment_mode"] == before + 1
    want = ref.segment_mode_ref(key >> 32, key & 0xFFFFFFFF, sw, n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the offload entry sorts and launches the same kernel; and the CPU
    # path gives the same bits
    full = offload.segment_weighted_mode(idx, lab, w, n)
    cpu = offload.segment_weighted_mode(idx.cpu(), lab.cpu(), w.cpu(), n)
    for a, b, c in zip(full, got, cpu):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


def test_run_sum_in_order(cuda):
    """run_sum adds each id's weights in stream order, like the CPU's
    index_add_: bit-equal to the plain version (which sums on the host)
    over runs of one to 100k items of f32 weights spanning six orders of
    magnitude."""
    from repro_torch.kernels import segment_mode as SM
    gen = _gen(32)
    n = 5000
    idx = torch.sort(torch.cat([
        torch.full((100_000,), 3, device=cuda),
        torch.randint(-2, n + 2, (60_000,), device=cuda, generator=gen)]),
        stable=True).values
    w = torch.rand(idx.numel(), device=cuda, generator=gen) * \
        10.0 ** torch.randint(-3, 3, (idx.numel(),), device=cuda,
                              generator=gen).float()
    before = SM.LAUNCHES["run_sum"]
    got = SM.run_sum_kernel_call(idx, w, n)
    torch.cuda.synchronize()
    assert SM.LAUNCHES["run_sum"] == before + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, ref.run_sum_ref(idx, w, n))
    # the double entry, as modularity takes it
    got64 = SM.run_sum_kernel_call(idx, w.double(), n)
    assert got64.dtype == torch.float64
    assert torch.equal(got64, ref.run_sum_ref(idx, w.double(), n))


def test_lpa_card_matches_cpu(cuda):
    """label_propagation at scale 12 on the card equals the CPU path bit
    for bit in every mode, and two card runs give equal labels."""
    from repro_torch.core.algorithms import label_propagation
    from repro_torch.kernels import segment_mode as SM
    g = rmat(12, 16, seed=8)
    c = _cpu(g)
    before = SM.LAUNCHES["segment_mode"]
    for mode in ("pull", "push", "auto"):
        got = label_propagation(g, iters=6, mode=mode)
        assert torch.equal(got.cpu(), label_propagation(c, iters=6,
                                                        mode=mode))
    assert torch.equal(label_propagation(g, iters=6), got)
    assert SM.LAUNCHES["segment_mode"] >= before + 24


def test_multilevel_card_matches_cpu(cuda):
    """multilevel at scale 12 (f32 weights) on the card equals the CPU path:
    labels and scores bit for bit, through segment_mode and run_sum."""
    from repro_torch.core.algorithms import multilevel
    from repro_torch.kernels import segment_mode as SM
    g = rmat(12, 16, seed=9)
    before = dict(SM.LAUNCHES)
    lab, scores = multilevel(g)
    torch.cuda.synchronize()
    assert SM.LAUNCHES["segment_mode"] > before["segment_mode"]
    assert SM.LAUNCHES["run_sum"] > before["run_sum"]
    lab_c, scores_c = multilevel(_cpu(g))
    assert torch.equal(lab.cpu(), lab_c) and scores == scores_c
    assert len(scores) >= 1 and all(b > a for a, b in zip(scores,
                                                          scores[1:]))


@pytest.mark.parametrize("edge_op", ["copy", "mul"])
def test_sample_push_equals_pull_on_card(cuda, edge_op):
    """The 'sample' combine keys each priority on the edge's CSR position,
    so push and pull pick alike on the card, and the card equals the CPU
    for the uniform draw; every pick is a real in-neighbour's payload."""
    from repro_torch.core.graph import _edge_keys

    def prog():
        def msg_fn(s, f):
            return torch.where(f > 0, s["v"], -1)

        def upd(s, acc, f, it):
            return {"v": s["v"], "p": acc[1]}, torch.zeros_like(f)
        return engine.VertexProgram(edge_op=edge_op, combine="sample",
                                    msg_fn=msg_fn, update_fn=upd)

    g = rmat(12, 16, seed=10)
    n = g.n_rows
    f0 = (torch.rand(n, device=cuda, generator=_gen(33)) < 0.3).to(
        torch.int32)
    v0 = torch.arange(n, dtype=torch.int32, device=cuda)
    picks = [engine.run(g, prog(), {"v": v0}, f0, max_iters=1, mode=m,
                        key=123)["p"] for m in ("push", "pull")]
    assert torch.equal(picks[0], picks[1])
    p = picks[0]
    hit = p >= 0
    assert bool(f0[p[hit].long()].all())
    keys = _edge_keys(g)
    want = p[hit].long() * n + torch.nonzero(hit).squeeze(1)
    assert bool(torch.isin(want, keys).all())
    if edge_op == "copy":
        c = _cpu(g)
        got = engine.run(c, prog(), {"v": v0.cpu()}, f0.cpu(), max_iters=1,
                         mode="pull", key=123)["p"]
        assert torch.equal(got, p.cpu())


def test_distributed_bfs_on_the_card_matches_cpu(cuda, tmp_path):
    """Two ranks sharing the card over gloo (CUDA tensors): direction-
    optimizing ``bfs_distributed`` and ``msbfs_distributed`` at RMAT-16
    equal the CPU path bit for bit."""
    import numpy as np
    from repro_torch.core.algorithms import msbfs
    from repro_torch.launch import mesh as TM
    import _torch_dist_cases as C

    got = TM.spawn(C.run_card_case, 2, init_file=str(tmp_path / "init"),
                   timeout=600, coll_timeout=120)[0]
    assert got["backend"] == "gloo" and got["device"].startswith("cuda")
    g = rmat(C.CARD_SCALE, 16, seed=7, device="cpu")
    np.testing.assert_array_equal(got["bfs"], bfs(g, 0).numpy())
    np.testing.assert_array_equal(got["msbfs"],
                                  msbfs(g, C.CARD_SOURCES).numpy())


@pytest.mark.parametrize("placement", ["sync", "async"])
def test_mesh_service_on_the_card_matches_cpu(cuda, tmp_path, placement):
    """``GraphService(mesh=...)`` on two ranks sharing the card over gloo
    (CUDA tensors) answers the stream, an insert batch and the stream
    again as the local service does on the CPU."""
    import numpy as np
    from repro_torch.core import service as TS
    from repro_torch.launch import mesh as TM
    import _torch_dist_cases as C

    got = TM.spawn(C.run_card_service, 2, init_file=str(tmp_path / "init"),
                   args=(placement,), timeout=600, coll_timeout=120)[0]
    assert got["device"].startswith("cuda")
    g = rmat(12, 16, seed=7, device="cpu")
    want = C.run_service(TS.GraphService(g, batch_budget=C.SVC_BUDGET,
                                         n_model_shards=2), g.n_rows, TS)
    np.testing.assert_array_equal(got["answers"], want["answers"])
    assert got["batches"] == want["batches"] and got["hits"] == want["hits"]


# -- the model stack's serving path: B6 at decode shapes, LMs card vs CPU ---

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_decode_shapes_match_plain(cuda, dtype):
    """One query row per (batch, head) over a cache's visible keys, as
    ``transformer.decode_step`` calls B6: before the ring wraps (causal,
    33-544 keys, with and without a window) and after (all slots, no
    mask), at qwen3-14b's heads, within the B6 tolerances.  The keys are
    the first slots of a 544-slot cache, read in place."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    tol = 2e-4 if dtype == torch.float32 else 5e-2
    gen = _gen(21)
    cases = [(33, True, None), (128, True, None), (544, True, None),
             (300, True, 64), (544, True, 256), (256, False, None),
             (544, False, None)]
    for skv, causal, window in cases:
        q = torch.randn(4, 40, 1, 128, device=cuda, generator=gen).to(dtype)
        k, v = (torch.randn(4, 8, 544, 128, device=cuda, generator=gen).to(
            dtype)[:, :, :skv] for _ in range(2))
        assert FA.kv_rows(k, v) == 544
        FA.reset_launches()
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert FA.LAUNCHES["flash_attention"] == 1
        assert FA.LAUNCHES["flash_attention_wgmma"] == 0
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=lambda m: f"{skv}: {m}")
        row = (got.float() - want.float()).norm(dim=-1) / \
            want.float().norm(dim=-1).clamp_min(1e-30)
        assert float(row.max()) <= 1e-2, (skv, float(row.max()))


@pytest.mark.parametrize("rank", [0, 3])
def test_flash_attention_on_one_ranks_heads_matches_plain(cuda, rank):
    """B6 on one rank's head slice of qwen3-14b served over 4 ranks of a
    (1, 4) grid (q heads 10 r .. 10 r + 9 read kv heads 2 r, 2 r + 1): a
    prefill of 4 x 512 on the wgmma path and a decode step over the first
    513 slots of a 544-slot cache on the split path, each within the B6
    tolerances of its plain version, which agrees with those heads of the
    whole attention's plain version to bf16 rounding."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    gen = _gen(40 + rank)
    H, Kv, hd, B = 40, 8, 128, 4
    q_heads = slice(10 * rank, 10 * rank + 10)
    kv_heads = slice(2 * rank, 2 * rank + 2)
    for sq, skv, slots, path in ((512, 512, 512, "flash_attention_wgmma"),
                                 (1, 513, 544, "flash_attention_split")):
        q = torch.randn(B, H, sq, hd, device=cuda, generator=gen).to(
            torch.bfloat16)
        k, v = (torch.randn(B, Kv, slots, hd, device=cuda, generator=gen).to(
            torch.bfloat16)[:, :, :skv] for _ in range(2))
        qr, kr, vr = q[:, q_heads], k[:, kv_heads], v[:, kv_heads]
        FA.reset_launches()
        got = ops.flash_attention(qr, kr, vr, causal=True)
        torch.cuda.synchronize()
        assert FA.LAUNCHES["flash_attention"] == 1 and FA.LAUNCHES[path] == 1
        want = ref.flash_attention_ref(qr, kr, vr, causal=True)
        whole = ref.flash_attention_ref(q, k, v, causal=True)[:, q_heads]
        torch.testing.assert_close(want.float(), whole.float(), rtol=1e-2,
                                   atol=1e-2)
        torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                                   atol=5e-2)
        row = (got.float() - want.float()).norm(dim=-1) / \
            want.float().norm(dim=-1).clamp_min(1e-30)
        assert float(row.max()) <= 1e-2, (sq, float(row.max()))


@pytest.mark.parametrize("arch,prompt,gen", [("qwen3-14b", 12, 6),
                                             ("mixtral-8x7b", 12, 6),
                                             ("mixtral-8x7b", 6, 10)])
def test_lm_smoke_on_the_card_matches_cpu(cuda, arch, prompt, gen):
    """The smoke config's forward, and prefill then greedy decode through
    ``serve_lm`` (mixtral: its ring wraps past the window 8 from a longer
    prompt and from a window-sized cache), on the card with B6 against the
    same parameters on the CPU (f32, 1e-4)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer as T
    cfg = get_config(arch).smoke
    cpu = T.Transformer(cfg, seed=1, device="cpu")
    card = T.Transformer(cfg, seed=1, device="cpu").to(cuda)
    prompts = np.random.default_rng(prompt).integers(
        0, cfg.vocab, (2, prompt)).astype(np.int32)
    FA.reset_launches()
    with torch.no_grad():
        got, _ = T.forward(cfg, card, torch.from_numpy(prompts).to(cuda))
        want, _ = T.forward(cfg, cpu, torch.from_numpy(prompts))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert FA.LAUNCHES["flash_attention"] == cfg.n_layers
    FA.reset_launches()
    g, w = serve_lm(cfg, card, prompts, gen), serve_lm(cfg, cpu, prompts, gen)
    assert FA.LAUNCHES["flash_attention"] == cfg.n_layers * (1 + gen)
    np.testing.assert_array_equal(g["tokens"], w["tokens"])
    torch.testing.assert_close(g["logits"].cpu(), w["logits"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("d", [1, 64, 100])
def test_segment_sum_under_autograd_matches_plain(cuda, d):
    """The GNN path's B4 Functions on the card: ``gnn.segment_sum``
    launches B4 forward and gathers backward, ``gnn.gather_rows`` gathers
    forward and launches B4 backward; both against the same calls on the
    CPU (unsorted ids, -1 and out-of-range ids dropped; 1e-4)."""
    from repro_torch.kernels import segment_sum as SS
    from repro_torch.models import gnn as G
    gen = torch.Generator().manual_seed(d)
    n, rows = 3000, 50_000
    seg = torch.randint(-1, n + 1, (rows,), generator=gen, dtype=torch.int32)
    data = torch.randn(rows, d, generator=gen)
    cot = torch.randn(n, d, generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        # detach: a leaf of its own on each device (to("cpu") is a no-op)
        x = data.to(dev).detach().requires_grad_(True)
        SS.reset_launches()
        y = G.segment_sum(x, seg.to(dev), n)
        launched = SS.LAUNCHES["segment_sum"]
        y.backward(cot.to(dev))
        t = cot.to(dev).detach().requires_grad_(True)
        z = G.gather_rows(t, seg.to(dev))
        z.backward(data.to(dev))
        out[dev] = [a.detach().cpu() for a in (y, x.grad, z, t.grad)]
        out[dev].append((launched, SS.LAUNCHES["segment_sum"]))
    assert out["cuda"][4] == (1, 2) and out["cpu"][4] == (0, 0)
    for got, want in zip(out["cuda"][:4], out["cpu"][:4]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [16, 64, 100])
def test_gather_segment_sum_under_autograd_matches_plain(cuda, d):
    """GIN's fused gather-and-sum on the card: one B4 launch forward and
    one backward, both against the same calls on the CPU (padded edges,
    random destinations, a hub source of 9,000 edges; within an f32 sum's
    error bound); a second call on the same plan gives equal bits."""
    from repro_torch.kernels import segment_sum as SS
    from repro_torch.models import gnn as G
    gen = torch.Generator().manual_seed(d)
    n, e = 3000, 60_000
    src = torch.randint(0, n, (e,), generator=gen, dtype=torch.int32)
    src[:9000] = 11
    src = src.sort().values
    dst = torch.randint(0, n, (e,), generator=gen, dtype=torch.int32)
    src[-500:] = dst[-500:] = -1
    x = torch.randn(n, d, generator=gen)
    cot = torch.randn(n, d, generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        plan = G.EdgePlan(src.to(dev), dst.to(dev), n, n)
        xx = x.to(dev).detach().requires_grad_(True)
        SS.reset_launches()
        y = G.gather_segment_sum(xx, src.to(dev), dst.to(dev), n, plan)
        y.backward(cot.to(dev))
        launched = SS.LAUNCHES["segment_sum"]
        again = G.gather_segment_sum(x.to(dev), src.to(dev), dst.to(dev), n,
                                     plan)
        assert torch.equal(again, y.detach())
        out[dev] = ([y.detach().cpu(), xx.grad.cpu()], launched, plan)
    assert out["cuda"][1] == 2 and out["cpu"][1] == 0
    plan = out["cpu"][2]
    for got, want, table, by in zip(out["cuda"][0], out["cpu"][0],
                                    (x, cot), ("dst", "src")):
        assert _within_sum_bound(got, want, table, *plan.form(by))


@pytest.mark.parametrize("arch", ["qwen3-14b", "minicpm3-4b", "mixtral-8x7b"])
def test_lm_smoke_gradients_on_the_card_match_cpu(cuda, arch):
    """One ``make_step`` train step of the smoke config on the card and on
    the CPU from the same parameters: the loss, every parameter's gradient
    (finite, 1e-4 of the largest) and the parameters after the step; B6
    launches no time in the train step (it has no backward)."""
    import copy
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.common import SpecBundle, init_params, make_step
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.optim import adamw
    ac = get_config(arch)
    cfg = ac.smoke
    cpu = init_params(ac, cfg, 0, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 24)).astype(np.int32))
    # the default warmup: step 1's lr is 3e-6, so a gradient whose sign
    # is rounding noise moves its parameter by less than the tolerance
    step = make_step(ac, SpecBundle("train", cfg, {}, {}), make_rules(None),
                     adamw.AdamWConfig())
    res = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        FA.reset_launches()
        st, m = step(adamw.init_state(model), {"tokens": toks})
        res[dev] = (float(m["loss"]), FA.LAUNCHES["flash_attention"],
                    {k: (p.grad.cpu(), p.detach().cpu())
                     for k, p in model.named_parameters()})
    assert res["cuda"][1] == 0
    assert res["cuda"][0] == pytest.approx(res["cpu"][0], rel=1e-5)
    scale = max(float(g.abs().max()) for g, _ in res["cpu"][2].values())
    for k, (g, p) in res["cuda"][2].items():
        gw, pw = res["cpu"][2][k]
        assert bool(torch.isfinite(g).all()), k
        torch.testing.assert_close(g, gw, rtol=1e-4, atol=1e-4 * scale)
        torch.testing.assert_close(p, pw, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [16, 64, 100])
@pytest.mark.parametrize("n,cap,share", [(4000, 5000, 0.3),
                                         (16384, 409600, 0.75)],
                         ids=["small", "meshed"])
def test_owner_side_b4_update_matches_plain(cuda, n, cap, share, d):
    """The owner-side sum of a meshed GNN step (``offload.segment_sum_rows``)
    on the card, on a routed arrival buffer: 4 source ranks' slots of
    capacity ``cap``, each a local id or -1 (an empty slot, a ``share`` of
    them), grouped by source rank, into ``n`` owner rows ("meshed": the
    shape of a meshed gin-tu step's owner sums).  One B4 launch, within an
    f32 sum's error bound of the float64 plain version; a planted fault
    (one arrival's slot emptied) fails the same check."""
    from repro_torch.core import offload
    from repro_torch.kernels import segment_sum as SS
    gen = torch.Generator().manual_seed(d)
    slots = 4 * cap
    local = torch.randint(0, n, (slots,), generator=gen, dtype=torch.int32)
    local[:3000] = 17                               # a hub destination
    empty = torch.rand(slots, generator=gen) < share
    empty[:3000] = False
    local[empty] = -1
    rows = torch.randn(slots, d, generator=gen)
    rows[empty] = 0.0

    def plain(ids):
        ok = ids >= 0
        return torch.zeros(n, d, dtype=torch.float64).index_add_(
            0, ids[ok].long(), rows[ok].double())

    def within(got, ids):
        ok = ids >= 0
        count = torch.zeros(n).index_add_(0, ids[ok].long(),
                                          torch.ones(int(ok.sum())))
        mass = torch.zeros(n, d).index_add_(0, ids[ok].long(),
                                            rows[ok].abs())
        return bool(((got.double() - plain(ids)).abs()
                     <= count[:, None] * 2.0 ** -24 * mass * 1.01
                     + 1e-6).all())

    SS.reset_launches()
    got = offload.segment_sum_rows(local.to(cuda), rows.to(cuda), n)
    torch.cuda.synchronize()
    assert SS.LAUNCHES["segment_sum"] == 1
    assert within(got.cpu(), local)
    planted = local.clone()
    planted[5] = -1                                 # a hub arrival lost
    bad = offload.segment_sum_rows(planted.to(cuda), rows.to(cuda), n)
    assert not within(bad.cpu(), local)

