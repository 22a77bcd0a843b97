"""The chunk plan of the port's EmbeddingBag (B5), on the CPU.

What the CUDA kernel (``csrc/embedding_bag.cu``) mirrors: the pieces it
sums (``embedding_bag.bag_pieces``: the runs of one bag inside each chunk of
``CHUNK`` lookups) and the order it sums them in (``ref.
embedding_bag_pieces_ref``: stream order inside a piece, chunk order across
a bag's pieces).  The pieces cover each bag's run exactly once, and a bag
split across chunks merges in chunk order.  The mirror gives the bits of a
scalar float32 loop in that order, agrees with the plain float64 version
and with the reference's Pallas kernel in interpret mode (1e-5, the
reference tests' tolerance), and writes 0 for empty bags.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import embedding_bag as EB
from repro_torch.kernels import ref
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

STREAMS = [  # n, n_bags, chunk, skewed
    (300, 40, 16, False), (300, 40, 7, False), (1000, 60, EB.CHUNK, False),
    (2000, 30, EB.CHUNK, True), (500, 200, 32, True), (64, 3, 8, True),
    (1, 5, 8, False)]


def _stream(n, n_bags, skewed, seed):
    """A bag-sorted stream: uniform bag ids, or one long bag among bags of
    1-3 lookups; some bags empty either way."""
    rng = np.random.default_rng(seed)
    if skewed:
        short = rng.integers(1, 4, n_bags)
        short[rng.random(n_bags) < 0.2] = 0          # empty bags
        short[n_bags // 3] = max(1, n - int(short.sum()))
        bag = np.repeat(np.arange(n_bags), short)[:n]
    else:
        bag = np.sort(rng.integers(0, n_bags, n))
    return torch.from_numpy(bag.astype(np.int32))


def _inputs(n, n_bags, skewed, seed, v=50, d=5, spread=True):
    rng = np.random.default_rng(seed + 1)
    bag = _stream(n, n_bags, skewed, seed)
    n = bag.shape[0]
    # magnitudes from 1e-4 to 1e4, so that the order of the sums shows
    scale = 10.0 ** rng.uniform(-4, 4, (v, d)) if spread else 1.0
    table = (rng.standard_normal((v, d)) * scale).astype(np.float32)
    idx = rng.integers(0, v, n).astype(np.int32)
    idx[rng.random(n) < 0.1] = -1
    w = rng.random(n).astype(np.float32)
    return torch.from_numpy(table), torch.from_numpy(idx), bag, \
        torch.from_numpy(w)


def _pieces(bag, chunk):
    starts = EB.bag_pieces(bag, chunk).tolist()
    return list(zip(starts, starts[1:] + [bag.shape[0]]))


@pytest.mark.parametrize("case", STREAMS)
def test_pieces_cover_each_bag_run_once(case):
    n, n_bags, chunk, skewed = case
    bag = _stream(n, n_bags, skewed, seed=n)
    pieces = _pieces(bag, chunk)
    covered = np.zeros(bag.shape[0], dtype=int)
    for a, e in pieces:
        assert a < e
        covered[a:e] += 1
        assert a // chunk == (e - 1) // chunk        # inside one chunk
        assert (bag[a:e] == bag[a]).all()            # one bag
        # maximal: it ends at a chunk edge or where the bag changes
        assert e == bag.shape[0] or e % chunk == 0 or bag[e] != bag[a]
    assert (covered == 1).all()


@pytest.mark.parametrize("case", STREAMS)
def test_split_bags_merge_in_chunk_order(case):
    n, n_bags, chunk, skewed = case
    bag = _stream(n, n_bags, skewed, seed=n)
    by_bag = {}
    for k, (a, e) in enumerate(_pieces(bag, chunk)):
        by_bag.setdefault(int(bag[a]), []).append((k, a, e))
    split = 0
    for b, ps in by_bag.items():
        ks = [k for k, _, _ in ps]
        assert ks == list(range(ks[0], ks[0] + len(ks)))   # consecutive
        chunks = [a // chunk for _, a, _ in ps]
        assert chunks == list(range(chunks[0], chunks[0] + len(ps)))
        for (_, _, e), (_, a, _) in zip(ps, ps[1:]):
            assert e == a and a % chunk == 0        # split at a chunk edge
        split += len(ps) > 1
    if skewed and n > chunk:
        assert split >= 1          # the long bag crosses a chunk edge


def _scalar_loop(table, idx, bag, n_bags, w, mode, chunk):
    """The kernel's order as a scalar float32 loop."""
    table, idx, bag = table.numpy(), idx.numpy(), bag.numpy()
    w = None if w is None else w.numpy()
    d, f32 = table.shape[1], np.float32
    out = np.zeros((n_bags, d), np.float32)
    totals = {}
    for a, e in _pieces(torch.from_numpy(bag), chunk):
        acc, ws = np.zeros(d, np.float32), f32(0)
        for i in range(a, e):
            ok = 0 <= idx[i] < table.shape[0]
            wi = f32(0) if not ok else (f32(1) if w is None else f32(w[i]))
            x = table[idx[i]] * wi if ok else np.zeros(d, np.float32)
            acc = (acc + x).astype(np.float32)
            ws = f32(ws + wi)
        t = totals.setdefault(int(bag[a]), [np.zeros(d, np.float32), f32(0)])
        t[0] = (t[0] + acc).astype(np.float32)
        t[1] = f32(t[1] + ws)
    for b, (acc, ws) in totals.items():
        if 0 <= b < n_bags:
            out[b] = acc / np.maximum(ws, f32(1e-9)) if mode == "mean" \
                else acc
    return out


@pytest.mark.parametrize("mode,weighted", [("sum", False), ("sum", True),
                                           ("mean", False), ("mean", True)])
@pytest.mark.parametrize("case", STREAMS[:2] + STREAMS[4:6])
def test_mirror_gives_the_bits_of_the_kernel_order(case, mode, weighted):
    n, n_bags, chunk, skewed = case
    table, idx, bag, w = _inputs(n, n_bags, skewed, seed=n)
    idx[::17] = table.shape[0] + 3                   # ids >= V add 0
    w = w if weighted else None
    got = ref.embedding_bag_pieces_ref(table, idx, bag, n_bags,
                                       EB.bag_pieces(bag, chunk), w, mode)
    want = _scalar_loop(table, idx, bag, n_bags, w, mode, chunk)
    assert np.array_equal(got.numpy(), want)
    plain = ref.embedding_bag_ref(table, idx, bag, n_bags, w, mode)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5 * float(
        table.abs().max()))


@pytest.mark.parametrize("mode,weighted", [("sum", False), ("mean", True)])
def test_mirror_matches_reference_kernel(mode, weighted):
    """Against the reference's Pallas kernel in interpret mode (through its
    sentinel-and-sort wrapper, so every bag is present there)."""
    table, idx, bag, w = _inputs(120, 20, True, seed=3, v=40, d=8,
                                 spread=False)
    w = w if weighted else None
    want = rops.embedding_bag(jnp.asarray(table.numpy()),
                              jnp.asarray(idx.numpy()),
                              jnp.asarray(bag.numpy()), 20,
                              None if w is None else jnp.asarray(w.numpy()),
                              mode)
    got = ref.embedding_bag_pieces_ref(table, idx, bag, 20,
                                       EB.bag_pieces(bag, 16), w, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_empty_bags_and_bags_out_of_range_come_out_zero():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 1
    # bags 0, 2, 5, 6 and 8 hold nothing; bag 9 is out of range for 9 bags
    bag = torch.tensor([1, 1, 3, 4, 4, 4, 7, 9], dtype=torch.int32)
    idx = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3], dtype=torch.int32)
    for chunk in (2, 3, EB.CHUNK):
        got = ref.embedding_bag_pieces_ref(table, idx, bag, 9,
                                           EB.bag_pieces(bag, chunk))
        want = ref.embedding_bag_ref(table, idx[:-1], bag[:-1], 9)
        assert torch.equal(got, want)
        assert not got[[0, 2, 5, 6, 8]].any()
