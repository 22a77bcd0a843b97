"""Port parity for the kernel entry point: ``repro_torch.kernels.ops``
(segment sum, EmbeddingBag, flash attention; on CPU tensors the plain
versions) against ``repro.kernels.ops`` (the Pallas kernels in interpret
mode), on the same numpy inputs, with the reference tests' cases and
tolerances (``tests/test_kernels.py``): 1e-5 for the sums, 2e-4 for f32
attention, 5e-2 for bf16.

Also: an unsorted seg against the reference oracle, EmbeddingBag's bag ids
outside [0, n_bags) against the reference oracle, the ValueError where a
query row would see no key, and the CUDA path raising on a host without a
card instead of falling back.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import _build
from repro_torch.kernels import embedding_bag as TEB
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import ops as tops
from repro_torch.core.graph import rmat, to_bbcsr
from repro_torch.kernels import segment_mode as TSM
from repro_torch.kernels import segment_or as TSO
from repro_torch.kernels import segment_sum as TSS
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("n,d,m,bn", [(100, 8, 13, 32), (500, 32, 64, 128),
                                      (1000, 1, 7, 256)])
def test_segment_sum_matches_reference_kernel(n, d, m, bn):
    rng = np.random.default_rng(n)
    seg = np.sort(rng.integers(0, m, n)).astype(np.int32)
    seg[-n // 10:] = -1                    # dropped rows at the tail
    data = rng.standard_normal((n, d)).astype(np.float32)
    want = rops.segment_sum_sorted(jnp.asarray(data), jnp.asarray(seg), m,
                                   block_n=bn)
    got = tops.segment_sum_sorted(_t(data), _t(seg), m, block_n=bn)
    assert got.dtype == torch.float32 and got.shape == (m, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_segment_sum_padding_dropped():
    seg = np.array([0, 0, 1, -1, -1], np.int32)
    data = np.ones((5, 4), np.float32)
    want = rops.segment_sum_sorted(jnp.asarray(data), jnp.asarray(seg), 2,
                                   block_n=4)
    got = tops.segment_sum_sorted(_t(data), _t(seg), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [[2] * 4, [1] * 4])


def test_segment_sum_unsorted_matches_reference_oracle():
    rng = np.random.default_rng(7)
    seg = rng.integers(-1, 20, 300).astype(np.int32)    # any order, -1 pads
    data = rng.standard_normal((300, 5)).astype(np.float32)
    want = rref.segment_sum_ref(jnp.asarray(data), jnp.asarray(seg), 20)
    got = tops.segment_sum_sorted(_t(data), _t(seg), 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("v,d,n,b,weighted,mode", [
    (50, 8, 40, 10, False, "sum"), (100, 16, 64, 7, True, "sum"),
    (30, 4, 25, 5, False, "mean"), (200, 32, 128, 16, True, "mean")])
def test_embedding_bag_matches_reference_kernel(v, d, n, b, weighted, mode):
    rng = np.random.default_rng(v + n)
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, v, n).astype(np.int32)
    idx[rng.random(n) < 0.1] = -1          # padding
    bag = np.sort(rng.integers(0, b, n)).astype(np.int32)
    w = rng.random(n).astype(np.float32) if weighted else None
    want = rops.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                              jnp.asarray(bag), b,
                              None if w is None else jnp.asarray(w), mode)
    got = tops.embedding_bag(_t(table), _t(idx), _t(bag), b,
                             None if w is None else _t(w), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the presorted path (no sentinels) gives the same rows for every bag
    # that holds a lookup; an empty bag comes out 0
    pre = tops.embedding_bag(_t(table), _t(idx), _t(bag), b,
                             None if w is None else _t(w), mode,
                             presorted=True).numpy()
    seen = np.isin(np.arange(b), bag)
    np.testing.assert_allclose(pre[seen], np.asarray(want)[seen], rtol=1e-5,
                               atol=1e-5)
    assert not pre[~seen].any()


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", [
    (1, 2, 2, 64, 64, 16), (2, 4, 2, 128, 128, 32), (1, 8, 1, 64, 64, 64),
    (2, 4, 4, 1, 128, 32),   # decode shape
])
@pytest.mark.parametrize("window", [None, 33])
def test_flash_attention_matches_reference_kernel(B, Hq, Hkv, Sq, Skv, D,
                                                  window):
    rng = np.random.default_rng(B * 1000 + Hq * 100 + Sq + D)
    q = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    want = rops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                block_q=1 if Sq == 1 else 32, block_k=32)
    got = tops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                               window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_flash_attention_bf16_matches_reference_kernel():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 2, 64, 32)).astype(np.float32)
               for _ in range(3))
    want = rops.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (q, k, v)), block_q=32,
                                block_k=32)
    got = tops.flash_attention(*(_t(a).to(torch.bfloat16)
                                 for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("mode,weighted", [("sum", False), ("mean", False),
                                           ("sum", True), ("mean", True)])
@pytest.mark.parametrize("presorted", [False, True])
def test_embedding_bag_drops_bag_ids_out_of_range(presorted, mode, weighted):
    """Bag ids -1 and >= n_bags give nothing, as in the CUDA kernel and the
    reference's oracle (whose Pallas kernel overwrites the last bag)."""
    rng = np.random.default_rng(3)
    n_bags, rows, d, n = 5, 12, 3, 60
    table = rng.standard_normal((rows, d)).astype(np.float32)
    idx = rng.integers(-1, rows, n).astype(np.int32)
    bag = rng.integers(-2, n_bags + 3, n).astype(np.int32)
    bag[:3] = [-1, n_bags, n_bags + 2]
    if presorted:
        order = np.argsort(bag, kind="stable")
        idx, bag = idx[order], bag[order]
    w = rng.random(n).astype(np.float32) if weighted else None
    want = rref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx),
                                  jnp.asarray(bag), n_bags,
                                  None if w is None else jnp.asarray(w), mode)
    got = tops.embedding_bag(_t(table), _t(idx), _t(bag), n_bags,
                             None if w is None else _t(w), mode,
                             presorted=presorted)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    small = tops.embedding_bag(torch.arange(12.).reshape(4, 3),
                               torch.tensor([0, 1, 2]),
                               torch.tensor([0, 1, 3]), 2,
                               presorted=presorted)
    np.testing.assert_array_equal(small.numpy(), [[0, 1, 2], [3, 4, 5]])


@pytest.mark.parametrize("sq,skv,causal,window", [
    (64, 32, True, None), (8, 8, True, 0), (8, 16, False, -3)])
def test_flash_attention_refuses_rows_without_keys(sq, skv, causal, window):
    q = torch.zeros(1, 2, sq, 16)
    k = torch.zeros(1, 2, skv, 16)
    with pytest.raises(ValueError, match="key"):
        tops.flash_attention(q, k, k, causal=causal, window=window)


def test_cuda_path_raises_without_a_card(monkeypatch):
    """Operands the wrappers take for CUDA ones go to the kernel, which
    cannot be built or launched here: they raise and never return the plain
    result; a device with no kernel is refused (meta, outside B4 and B6,
    whose operators take a dry run's meta operands)."""
    data = torch.ones(4, 3)
    seg = torch.tensor([0, 0, 1, -1], dtype=torch.int32)
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="device"):
        tops.embedding_bag(data.to("meta"), seg.to("meta"),
                           seg.abs().to("meta"), 2)
    monkeypatch.setattr(_build, "on_cpu", lambda tensors, what: False)
    before = (dict(TSS.LAUNCHES), dict(TEB.LAUNCHES), dict(TFA.LAUNCHES))
    for call in (lambda: tops.segment_sum_sorted(data, seg, 2),
                 lambda: tops.embedding_bag(data, seg, seg.abs(), 2),
                 lambda: tops.flash_attention(q, q, q)):
        with pytest.raises((RuntimeError, ValueError)):
            call()
    assert (TSS.LAUNCHES, TEB.LAUNCHES, TFA.LAUNCHES) == before


def _meta_bbcsr():
    bb = to_bbcsr(rmat(6, 4, seed=1, device="cpu"), block_rows=16,
                  block_cols=16, tile_nnz=16)
    return dataclasses.replace(bb, **{
        f.name: getattr(bb, f.name).to("meta") for f in dataclasses.fields(bb)
        if isinstance(getattr(bb, f.name), torch.Tensor)})


def _meta_calls():
    m = torch.ones(4, 3, device="meta")
    ids = torch.zeros(4, dtype=torch.int32, device="meta")
    words = torch.zeros(4, 2, dtype=torch.int32, device="meta")
    w = torch.ones(4, device="meta")
    x = torch.ones(64, device="meta")
    return {
        "embedding_bag": lambda: tops.embedding_bag(m, ids, ids, 2),
        "spmv_dma": lambda: tops.spmv_dma(_meta_bbcsr(), x),
        "segment_or": lambda: TSO.segment_or_kernel_call(ids, words, 2),
        "segment_mode": lambda: TSM.segment_mode_kernel_call(ids, ids, w, 2),
        "run_sum": lambda: TSM.run_sum_kernel_call(ids, w, 2),
        # B4 and B6 take meta only when every operand is meta
        "segment_sum mixed": lambda: tops.segment_sum_csr(
            m, torch.tensor([0, 2, 4])),
        "flash_attention mixed": lambda: tops.flash_attention(
            torch.zeros(1, 2, 4, 16, device="meta"), torch.zeros(1, 2, 4, 16),
            torch.zeros(1, 2, 4, 16)),
    }


@pytest.mark.parametrize("name", list(_meta_calls()))
def test_meta_operands_raise_outside_b4_and_b6(monkeypatch, name):
    """Only B4 and B6 have a torch operator whose meta kernel takes a dry
    run's meta tensors: every other wrapper refuses meta operands (and B4
    and B6 a mix of meta and host ones) with ValueError before it loads a
    library, so no launch ever reads a meta tensor's null pointer."""
    def no_load(name):
        raise AssertionError(f"library {name} loaded for meta operands")
    monkeypatch.setattr(_build, "load", no_load)
    with pytest.raises(ValueError, match="device"):
        _meta_calls()[name]()


def test_meta_operands_take_b4_and_b6_operators(monkeypatch):
    """B4 and B6 on meta operands (a dry run) call their operators' meta
    kernels: the output's shape and dtype, no library, no launch."""
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(name))
    before = (dict(TSS.LAUNCHES), dict(TFA.LAUNCHES))
    data = torch.ones(4, 3, device="meta")
    seg = torch.zeros(4, dtype=torch.int32, device="meta")
    out = tops.segment_sum_sorted(data, seg, 2)
    assert out.device.type == "meta" and out.shape == (2, 3) and \
        out.dtype == torch.float32
    q = torch.zeros(1, 4, 8, 64, dtype=torch.bfloat16, device="meta")
    k = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16, device="meta")
    out = tops.flash_attention(q, k, k)
    assert out.device.type == "meta" and out.shape == q.shape and \
        out.dtype == torch.bfloat16
    assert (TSS.LAUNCHES, TFA.LAUNCHES) == before
