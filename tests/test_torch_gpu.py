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
                  B, Hq, Hkv, Sq, Skv, 128, int(causal), window or 0,
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


def test_service_matches_cpu(cuda):
    """One seeded mixed stream (all four kinds, repeats, an edge update in
    one partition between two passes) through a CUDA service and a CPU
    service on rmat(10): Reachability, Distance and NeighborSample draws
    (the keyed hash is device-independent) and the spliced CSR bit-equal,
    PPR within 1e-5, stats equal."""
    import numpy as np
    from repro_torch.core import (Distance, NeighborSample, PPRTopK,
                                  Reachability, csr_from_numpy)
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
