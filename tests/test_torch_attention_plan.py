"""The host-side plan of the port's flash attention (B6), on the CPU.

What the CUDA kernels take from the wrapper (``repro_torch.kernels.
flash_attention``) and mirror: the key-split plan of the folded decode path
(pieces that cover each row tile's visible key blocks with no gap, no
overlap and no empty piece), the wgmma kernel's query-tile launch order
(heaviest first under a causal mask), the dispatch rule at its edges, and
which k / v layouts the folded kernels read in place (a decode cache's
first slots), the split-and-merge arithmetic, whose plain version (``ref.
flash_attention_split_ref``) is held against the plain attention and the
reference's Pallas kernel in interpret mode on one decode shape (f32,
2e-4, the reference tests' tolerance).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch import tune
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref

N_SM = 132   # an H100's SMs; the plan takes the count as an argument
# the tiles ops.flash_attention resolves for a decode step (Sq = 1) on the
# card, where the qwen3-14b cases below run
BQ = tune.resolve("kernels.flash_attention.block_q", n=1, device="cuda")
BK = tune.resolve("kernels.flash_attention.block_k", n=1, device="cuda")

PLAN_CASES = [  # B, Hkv, Sq, Skv, g, block_q, block_k, causal, window
    (1, 8, 1, 32768, 5, BQ, BK, True, None),      # qwen3-14b, batch 1
    (128, 8, 1, 32768, 5, BQ, BK, True, None),    # qwen3-14b, batch 128
    (1, 2, 1, 4173, 4, 16, 64, True, None),
    (1, 8, 1, 32768, 4, 64, 32, True, 4096),      # a window cuts the cache
    (2, 1, 3, 2000, 8, 16, 32, True, 300),
    (1, 4, 7, 999, 2, 32, 64, False, None),
    (1, 1, 40, 5000, 1, 16, 32, True, None),      # many row tiles
    (3, 2, 1, 77, 5, 16, 32, True, 20),           # too short to split
]


def _tiles(B, hkv, sq, skv, g, bq, bk, causal, window):
    return [FA.key_blocks(sq, skv, g, t * bq, bq, bk, causal, window)
            for t in range(-(-sq * g // bq))]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_split_pieces_cover_each_tiles_keys(case):
    B, hkv, sq, skv, g, bq, bk, causal, window = case
    splits = FA.split_plan(*case, n_sm=N_SM)
    assert splits >= 1
    for kb0, kb1 in _tiles(*case):
        pieces = [FA.split_range(kb0, kb1, s, splits) for s in range(splits)]
        assert pieces[0][0] == kb0 and pieces[-1][1] == kb1
        for (a, b), (c, _) in zip(pieces, pieces[1:]):
            assert b == c                       # no gap, no overlap
        for a, b in pieces:
            assert b - a >= (FA.MIN_SPLIT_BLOCKS if splits > 1 else 1)


@pytest.mark.parametrize("case", PLAN_CASES)
def test_key_blocks_hold_every_visible_key_of_a_tile(case):
    B, hkv, sq, skv, g, bq, bk, causal, window = case
    mask = ref.attention_mask(sq, skv, causal, window, "cpu")
    for t, (kb0, kb1) in enumerate(_tiles(*case)):
        rows = torch.arange(t * bq, min((t + 1) * bq, sq * g)) // g
        keys = mask[rows].any(0).nonzero().flatten()
        assert int(keys.min()) >= kb0 * bk and int(keys.max()) < kb1 * bk
        # the first and last blocks hold a visible key: none is skipped work
        assert int(keys.min()) < (kb0 + 1) * bk
        assert int(keys.max()) >= (kb1 - 1) * bk


def test_split_plan_splits_batch_one_decode_only():
    one = FA.split_plan(1, 8, 1, 32768, 5, BQ, BK, True, None, N_SM)
    many = FA.split_plan(128, 8, 1, 32768, 5, BQ, BK, True, None, N_SM)
    assert one > 1 and many == 1
    # at least about two waves of CTAs, with no piece under a few blocks
    assert 8 * one >= FA.SPLIT_WAVES * N_SM
    assert (32768 // BK) // one >= FA.MIN_SPLIT_BLOCKS
    # a cache too short for two pieces stays whole
    short = (2 * FA.MIN_SPLIT_BLOCKS - 1) * BK
    assert FA.split_plan(1, 8, 1, short, 5, BQ, BK, True, None, N_SM) == 1
    assert FA.split_plan(1, 8, 1, short + 1, 5, BQ, BK, True, None,
                         N_SM) == 2
    # prefill fills the card by its row tiles
    assert FA.split_plan(1, 8, 4096, 4096, 5, BQ, BK, True, None, N_SM) == 1


@pytest.mark.parametrize("sq,skv,causal,window", [
    (4096, 4096, True, None), (8192, 8192, True, 4096),
    (200, 130, False, None), (130, 200, True, None),
    (1000, 1000, False, 300), (64, 64, True, 33), (700, 3000, True, 1000)])
def test_tile_order_is_a_permutation_heaviest_first(sq, skv, causal, window):
    n_tiles = -(-sq // FA.WGMMA_TILE)
    order = FA.tile_order(n_tiles, causal)
    assert sorted(order) == list(range(n_tiles))
    # a CTA's time goes with the key blocks it walks: those from the first
    # to the last that hold a key some row of its tile sees
    mask = ref.attention_mask(sq, skv, causal, window, "cpu")
    tile = FA.WGMMA_TILE
    work = []
    for t in order:
        keys = mask[t * tile:(t + 1) * tile].any(0).nonzero().flatten()
        work.append(int(keys.max()) // tile - int(keys.min()) // tile + 1)
    assert work == sorted(work, reverse=True), work


@pytest.mark.parametrize("dtype,d,sq,want", [
    (torch.bfloat16, 128, FA.WGMMA_MIN_SQ, "wgmma"),
    (torch.bfloat16, 128, FA.WGMMA_MIN_SQ - 1, "mma"),
    (torch.bfloat16, 128, 4096, "wgmma"),
    (torch.bfloat16, 128, 1, "mma"),
    (torch.bfloat16, 64, 4096, "mma"),
    (torch.float32, 128, 4096, "simt"),
    (torch.float32, 128, 1, "simt")])
def test_dispatch_rule_at_its_edges(dtype, d, sq, want):
    assert FA.path(dtype, d, sq) == want


def test_split_merge_matches_plain_and_reference_kernel():
    """B 1, Hq 4, Hkv 2, Sq 1, Skv 256, cut into 4 pieces as the split
    decode path cuts them; f32 within 2e-4."""
    B, Hq, Hkv, Sq, Skv, D, bk, splits = 1, 4, 2, 1, 256, 32, 32, 4
    rng = np.random.default_rng(14)
    q = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    kb0, kb1 = FA.key_blocks(Sq, Skv, Hq // Hkv, 0, 16, bk, True, None)
    ranges = [tuple(bk * x for x in FA.split_range(kb0, kb1, s, splits))
              for s in range(splits)]
    assert len(set(ranges)) == splits and ranges[-1][1] == Skv
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    m, l, acc = ref.attention_pieces(tq, tk, tv, ranges)
    assert m.shape == (splits, B, Hq, Sq) and acc.shape[-1] == D
    assert bool(torch.isfinite(m).all()) and bool((l > 0).all())
    got = ref.flash_attention_split_ref(tq, tk, tv, ranges)
    want = ref.flash_attention_ref(tq, tk, tv)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    pallas = rops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, block_q=1,
                                  block_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-4,
                               atol=2e-4)


def test_split_merge_weighs_out_empty_pieces():
    """A piece whose keys a row cannot see (m = -inf, l = 0) adds nothing:
    under a window the first pieces of a long cache are such pieces."""
    rng = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 2, 1, 16), (1, 1, 300, 16), (1, 1, 300, 16)))
    ranges = [(0, 100), (100, 200), (200, 300)]
    m, l, _ = ref.attention_pieces(q, k, v, ranges, window=50)
    assert bool((m[0] == float("-inf")).all()) and bool((l[0] == 0).all())
    torch.testing.assert_close(
        ref.flash_attention_split_ref(q, k, v, ranges, window=50),
        ref.flash_attention_ref(q, k, v, window=50), rtol=2e-4, atol=2e-4)


def test_kv_rows_reads_a_cache_in_place_and_nothing_else():
    """The folded kernels' row stride: a contiguous k / v is its own Skv,
    the first slots of a (B, Hkv, Smax, D) cache give Smax, and a layout
    the kernels cannot walk (heads or batches out of order, a row not on a
    16-byte boundary, k and v laid out unlike) gives None (made contiguous
    first)."""
    cache = torch.zeros(3, 2, 40, 16)
    assert FA.kv_rows(cache, cache.clone()) == 40
    assert FA.kv_rows(cache[:, :, :9], cache[:, :, :9]) == 40
    assert FA.kv_rows(cache[:1, :1, :9], cache[:1, :1, :9]) == 40
    bshd = torch.zeros(3, 40, 2, 16)
    assert FA.kv_rows(bshd.transpose(1, 2), bshd.transpose(1, 2)) is None
    assert FA.kv_rows(cache[:, :, 1:9], cache[:, :, 1:9]) == 40
    assert FA.kv_rows(cache[..., 1:9], cache[..., 1:9]) is None
    assert FA.kv_rows(cache[:, :1], cache[:, :1]) is None
    assert FA.kv_rows(cache[:, :, :9], cache[:, :, :9].contiguous()) is None
    odd = torch.zeros(3 * 2 * 40 * 16 + 1)[1:].view(3, 2, 40, 16)
    assert FA.kv_rows(odd, odd) is None
