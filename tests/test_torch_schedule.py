"""The BBCSR kernels' schedule (``repro_torch.kernels.spmv_dma.plan``) on
the CPU, against a direct numpy computation on the reference's own
``to_bbcsr`` arrays: the live-slot prefix sum of the live tiles, the share
boundaries, the share size, the active-tile prefix sum and each row
block's live-slot offset.  Then the shares walked as ``csrc/bbcsr.cu``
walks them: every live slot is read by exactly one share, and a row block
is written by one share or combined by the fixup pass from the shares its
live slots span.
"""
import numpy as np
import pytest
import torch

from repro.core import graph as RG
from repro_torch.core import graph as TG
from repro_torch.kernels import spmv_dma as TK
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

BB_FIELDS = ("rows_local", "cols_local", "vals", "tile_rb", "tile_cb",
             "tile_init", "tile_cnt")


def _hub_graph(seed=0):
    """Vertex 3's in-edges come from every vertex: as the pull operand's
    rows, row block 0 holds several shares of live slots."""
    rng = np.random.default_rng(seed)
    n = 512
    src = np.concatenate([np.arange(n), rng.integers(0, n, 1500)])
    dst = np.concatenate([np.full(n, 3), rng.integers(0, n, 1500)])
    return RG.CSR.from_coo(dst, src, rng.random(src.size).astype(np.float32),
                           n, n, sum_duplicates=True)


def _gapped_graph(seed=1):
    """Rows 8-39 and 48-63 hold no edges (all-padding row blocks), and
    n_rows is no multiple of the row block."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, 8, 300), rng.integers(40, 48, 80)])
    cols = rng.integers(0, 61, 380)
    return RG.CSR.from_coo(rows, cols, rng.random(380).astype(np.float32),
                           61, 61, sum_duplicates=True)


GRAPHS = {"rmat10": lambda: RG.rmat(10, 8, seed=10), "hub": _hub_graph,
          "gapped": _gapped_graph}
CASES = [("rmat10", (64, 128, 64)), ("rmat10", (32, 32, 256)),
         ("hub", (32, 64, 32)), ("gapped", (8, 16, 8))]


def _operands(name, geom):
    br, bc, tn = geom
    rbb = RG.to_bbcsr(GRAPHS[name](), block_rows=br, block_cols=bc,
                      tile_nnz=tn)
    fields = {f: np.asarray(getattr(rbb, f)) for f in BB_FIELDS}
    fields.update(n_rows=rbb.n_rows, n_cols=rbb.n_cols, block_rows=br,
                  block_cols=bc, tile_nnz=tn)
    return fields, TG.bbcsr_from_numpy(fields, device="cpu")


def _active(fields, frac, seed=3):
    """tile_active as the engine forms it: a tile is active iff its column
    block holds a frontier vertex."""
    if frac is None:
        return None
    rng = np.random.default_rng(seed)
    n_cb = -(-fields["n_cols"] // fields["block_cols"])
    on = rng.random(n_cb) < frac
    return on[fields["tile_cb"]].astype(np.int32)


def _numpy_plan(fields, act, shares):
    """The schedule, tile by tile in plain Python."""
    cnt, tile_rb = fields["tile_cnt"], fields["tile_rb"]
    n_rb = -(-fields["n_rows"] // fields["block_rows"])
    list_tile, list_ptr, rb_slot = [], [], [None] * (n_rb + 1)
    s = 0
    for t in range(cnt.size):
        if t == 0 or tile_rb[t] != tile_rb[t - 1]:
            rb_slot[tile_rb[t]] = s
        if cnt[t] > 0 and (act is None or act[t] != 0):
            list_tile.append(t)
            list_ptr.append(s)
            s += int(cnt[t])
    list_ptr.append(s)
    rb_slot[n_rb] = s
    share = 32 * int(np.ceil(np.ceil(s / shares) / 32))
    share = min(TK.SHARE_MAX, max(TK.SHARE_MIN, share))
    n_chunks = -(-s // share)
    chunk_first = []
    for k in range(n_chunks):
        e = 0
        while list_ptr[e + 1] <= k * share:
            e += 1
        chunk_first.append(e)
    chunk_first.append(len(list_tile))
    return dict(list_tile=list_tile, list_ptr=list_ptr,
                chunk_first=chunk_first, rb_slot=rb_slot,
                meta=[len(list_tile), n_chunks, share])


@pytest.mark.parametrize("frac", [None, 1.0, 0.3, 0.0])
@pytest.mark.parametrize("shares", [TK.SHARES, 16])
@pytest.mark.parametrize("name,geom", CASES)
def test_plan_matches_numpy(name, geom, shares, frac):
    fields, bb = _operands(name, geom)
    act = _active(fields, frac)
    got = TK.plan_ref(bb, None if act is None else torch.from_numpy(act),
                      shares=shares)
    want = _numpy_plan(fields, act, shares)
    for key, arr in want.items():
        assert getattr(got, key).dtype == torch.int32
        assert getattr(got, key).tolist() == arr, key
    if shares == TK.SHARES:          # plan() on CPU tensors is plan_ref
        again = TK.plan(bb, None if act is None else torch.from_numpy(act))
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def _walk(p, fields):
    """The product kernel's walk, index for index: each share from its
    first entry; a window of up to 128 entries, reloaded when fewer than 32
    follow the current one; lane l looking at the (l + 1)-th entry after
    it; a stretch of at most 128 slots that ends where the 32nd entry
    starts or a 3rd row block would start; a lane's entry found by
    counting the entry starts at or before its slot.  Returns the times each slot was
    read and, per share, the row blocks it flushed."""
    win, slices = 128, 2
    lt, lp, cf = p.list_tile.tolist(), p.list_ptr.tolist(), \
        p.chunk_first.tolist()
    n_list, n_chunks, share = p.meta.tolist()
    total = lp[n_list]
    cnt, tile_rb, T = fields["tile_cnt"], fields["tile_rb"], \
        fields["tile_nnz"]
    seen = np.zeros(cnt.size * T, dtype=np.int64)
    flushed = []
    for c in range(n_chunks):
        s0, s1 = c * share, min((c + 1) * share, total)
        cur, wbase, wn, wend = cf[c], cf[c], 0, 0
        b, p0, pieces = -1, s0, []
        while p0 < s1:
            kc = cur - wbase
            if kc + 32 >= wn and (kc >= wn or wbase + wn < n_list):
                wbase, wn = cur, min(win, n_list - cur)
                wend, kc = lp[wbase + wn], 0
            rb = tile_rb[lt[cur]]
            if rb != b:
                if b >= 0:
                    pieces.append(b)
                b = rb
            ks = [kc + 1 + lane for lane in range(32)]
            pk = [lp[wbase + k] if k < wn else wend for k in ks]
            rbl = [tile_rb[lt[wbase + k]] if k < wn else -1 for k in ks]
            lim = min(p0 + win, s1, pk[31])
            chg = [k < wn and q < lim and r != prev for k, q, r, prev
                   in zip(ks, pk, rbl, [b] + rbl[:-1])]
            pe = lim
            if sum(chg) >= slices:          # the slices-th row block starts
                pe = [q for q, ch in zip(pk, chg) if ch][slices - 1]
            starts = [q - p0 for q in pk if q < pe]
            assert all(0 < q < win for q in starts) and len(starts) < 32
            blocks = [b] + [r for q, r, ch in zip(pk, rbl, chg)
                            if ch and q < pe]
            assert len(blocks) <= slices
            for s in range(p0, pe):
                k = kc + sum(q <= s - p0 for q in starts)
                t = lt[wbase + k]
                off = s - lp[wbase + k]
                assert 0 <= off < cnt[t] and tile_rb[t] in blocks
                seen[t * T + off] += 1
            pieces += blocks[:-1]
            b = blocks[-1]
            n_in = len(starts)
            cur = wbase + kc + n_in + (1 if pk[n_in] <= pe else 0)
            p0 = pe
        if b >= 0:
            pieces.append(b)
        flushed.append(pieces)
    return seen, flushed


@pytest.mark.parametrize("frac", [None, 0.3])
@pytest.mark.parametrize("shares", [TK.SHARES, 16])
@pytest.mark.parametrize("name,geom", CASES)
def test_shares_read_each_live_slot_once(name, geom, shares, frac):
    """Every live slot is read once; each row block is flushed by exactly
    the shares its live slots span, r0 // share .. (r1 - 1) // share, once
    each, and is written whole only when that is one share."""
    fields, bb = _operands(name, geom)
    act = _active(fields, frac)
    p = TK.plan_ref(bb, None if act is None else torch.from_numpy(act),
                    shares=shares)
    seen, flushed = _walk(p, fields)
    cnt, T = fields["tile_cnt"], fields["tile_nnz"]
    live = np.zeros_like(seen)
    for t in range(cnt.size):
        if cnt[t] > 0 and (act is None or act[t] != 0):
            live[t * T:t * T + cnt[t]] = 1
    assert np.array_equal(seen, live)
    share = int(p.meta[2])
    rs = p.rb_slot.tolist()
    by_block = {}
    for c, pieces in enumerate(flushed):
        assert len(set(pieces)) == len(pieces)
        for b in pieces:
            by_block.setdefault(b, []).append(c)
    for b in range(bb.n_row_blocks):
        r0, r1 = rs[b], rs[b + 1]
        if r0 == r1:                       # the identity, from the fixup
            assert b not in by_block
        else:
            assert by_block[b] == list(range(r0 // share,
                                             (r1 - 1) // share + 1))


def test_bbcsr_nnz_is_the_real_slot_count():
    g = TG.rmat(8, 8, seed=2, device="cpu")
    bb = TG.to_bbcsr(g, block_rows=32, block_cols=64, tile_nnz=32)
    assert bb.nnz == g.nnz == int(bb.tile_cnt.sum())
    fields, pbb = _operands("gapped", (8, 16, 8))
    assert pbb.nnz == int(fields["tile_cnt"].sum())
