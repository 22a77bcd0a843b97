"""MS-BFS's dense pull as a CSR row OR: ``offload.segment_or_rows`` (the
``segment_or_rows`` kernel of ``csrc/segment_or.cu`` on the card, its plain
version ``ref.segment_or_rows_ref`` here) against the live reference's
``segment_or(p_dst, take(msg, p_src), n, presorted=True)`` under
``jax.jit``, bit for bit, on the same numpy inputs; ``msbfs`` through it;
the engine's per-CSR operand (``engine._dst_csr``) against the
destination-sorted stream it is built from.

Lane words are int32 in the port, the reference's uint32 viewed as int32.
The kernel cuts the merge path of rows and items into shares of 2,048
positions, so the hub case spans several shares; on the card
``tests/test_torch_gpu.py`` holds the kernel to the plain version on these
streams.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithms as RA
from repro.core import graph as RG
from repro.core import offload as RO
from repro_torch.core import algorithms as TA
from repro_torch.core import engine as TE
from repro_torch.core import graph as TG
from repro_torch.core import offload as TO
from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels import segment_or as TSO
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

# 33 lanes (two words), vertices 0 and 4 twice
SOURCES = np.r_[np.arange(31) * 4, 0, 4].astype(np.int32)


def _ref_rows(p_dst, msg, p_src, n):
    """The reference's dense step on uint32 words: its gather with its
    padding rule (a source out of range reads 0), then its presorted OR."""
    fn = jax.jit(lambda d, x, s: RO.segment_or(
        d, RO.dma_gather(x, s, fill=0), n, presorted=True))
    return np.asarray(fn(jnp.asarray(p_dst), jnp.asarray(msg),
                         jnp.asarray(p_src))).view(np.int32)


def _stream(deg, pre, post, t_rows, rng):
    """A destination-sorted stream: ``pre`` items before the rows (id -1),
    then deg[v] items of each row v, then ``post`` items past them (id n),
    sources in [-2, t_rows + 2): some out of range."""
    n = len(deg)
    p_dst = np.concatenate([np.full(pre, -1), np.repeat(np.arange(n), deg),
                            np.full(post, n)]).astype(np.int32)
    p_src = rng.integers(-2, t_rows + 2, p_dst.size).astype(np.int32)
    return p_dst, p_src


def _rmat_stream(scale):
    g = RG.rmat(scale, 8, seed=scale)
    indices = np.asarray(g.indices)
    order = np.argsort(indices, kind="stable")
    rows = np.repeat(np.arange(g.n_rows), np.diff(np.asarray(g.indptr)))
    return g.n_rows, indices[order], rows[order].astype(np.int32)


def _case(name):
    rng = np.random.default_rng(len(name))
    if name.startswith("rmat10"):
        n, p_dst, p_src = _rmat_stream(10)
        W = 2 if name.endswith("w2") else 1
        t_rows = n
    elif name == "hub":
        # row 3 holds 10,000 items (about five shares) beside short rows
        deg = rng.integers(0, 4, 300)
        deg[3] = 10_000
        p_dst, p_src = _stream(deg, 0, 0, 400, rng)
        n, W, t_rows = 300, 1, 400
    elif name == "empty_rows":
        # leading and trailing rows with no edges, items outside the rows
        deg = rng.integers(0, 6, 90)
        deg[:20] = 0
        deg[-25:] = 0
        p_dst, p_src = _stream(deg, 7, 5, 60, rng)
        n, W, t_rows = 90, 2, 60
    elif name == "m0":
        n, W, t_rows = 6, 2, 6
        p_dst = p_src = np.zeros(0, np.int32)
    else:                                    # n0: no rows, items dropped
        n, W, t_rows = 0, 1, 4
        p_dst, p_src = _stream(np.zeros(0, np.int64), 2, 3, t_rows, rng)
    msg = rng.integers(0, 2 ** 32, (t_rows, W), dtype=np.uint64).astype(
        np.uint32)
    if t_rows:
        msg[::5] = 0xFFFFFFFF                # every bit, the sign bit too
        msg[1::7] = 0x80000000               # the sign bit alone
    offsets = np.searchsorted(p_dst, np.arange(n + 1)).astype(np.int32)
    return n, p_dst, p_src, offsets, msg


@pytest.mark.parametrize("name", ["rmat10_w1", "rmat10_w2", "hub",
                                  "empty_rows", "m0", "n0"])
def test_rows_plain_version_matches_reference(name):
    n, p_dst, p_src, offsets, msg = _case(name)
    want = _ref_rows(p_dst, msg, p_src, n)
    args = (torch.from_numpy(offsets), torch.from_numpy(p_src),
            torch.from_numpy(msg.view(np.int32)), n)
    got = TO.segment_or_rows(*args)
    assert got.dtype == torch.int32 and got.shape == (n, msg.shape[1])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ref.segment_or_rows_ref(*args).numpy(),
                                  want)


def test_msbfs_dense_levels_take_segment_or_rows(monkeypatch):
    """Every pull level of the packed lanes is one segment_or_rows call and
    no generic segment_or call; the levels equal the reference's."""
    g = RG.rmat(7, 8, seed=11)
    t = TG.csr_from_numpy(np.asarray(g.indptr), np.asarray(g.indices),
                          np.asarray(g.values), g.n_rows, g.n_cols,
                          device="cpu")
    calls = {"segment_or_rows": 0, "segment_or": 0}
    for name in calls:
        fn = getattr(TO, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(TO, name, counted)
    lv, rstats = RA.msbfs(g, SOURCES, mode="auto", return_stats=True)
    tl, tstats = TA.msbfs(t, SOURCES, mode="auto", return_stats=True)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(lv))
    assert tstats["pulls"] == int(rstats["pulls"]) > 0
    assert calls == {"segment_or_rows": tstats["pulls"],
                     "segment_or": tstats["pushes"]}
    for k in calls:
        calls[k] = 0
    pulled = TA.msbfs(t, SOURCES, mode="pull")
    np.testing.assert_array_equal(pulled.numpy(), np.asarray(lv))
    assert calls["segment_or"] == 0 and calls["segment_or_rows"] > 0


def test_dst_csr_matches_dst_sorted():
    """The CSR form is the destination-sorted stream: the same sources in
    the same order, and each row's run where offsets says."""
    n, p_dst, p_src, offsets, _ = _case("rmat10_w1")
    g = RG.rmat(10, 8, seed=10)
    t = TG.csr_from_numpy(np.asarray(g.indptr), np.asarray(g.indices),
                          None, g.n_rows, g.n_cols, device="cpu")
    off, src = TE._dst_csr(t)
    s64, dst, _ = TE._dst_sorted(t)
    assert off.dtype == src.dtype == torch.int32
    assert off.shape == (n + 1,) and TE._dst_csr(t) is TE._dst_csr(t)
    assert torch.equal(src.long(), s64)
    np.testing.assert_array_equal(src.numpy(), p_src)
    np.testing.assert_array_equal(off.numpy(), offsets)
    np.testing.assert_array_equal(
        np.repeat(np.arange(n), np.diff(off.numpy())), dst.numpy())


def test_rows_wrapper_raises_on_meta_and_without_a_card(monkeypatch):
    """Meta tensors have no kernel; CUDA operands go to the kernel, which
    cannot be built or launched here.  Neither counts a launch."""
    args = (torch.tensor([0, 1, 2], dtype=torch.int32),
            torch.tensor([1, 0], dtype=torch.int32),
            torch.ones((2, 1), dtype=torch.int32), 2)
    before = dict(TSO.LAUNCHES)
    with pytest.raises(ValueError, match="meta"):
        TO.segment_or_rows(*(a.to("meta") for a in args[:3]), 2)
    with pytest.raises(ValueError, match="want offsets"):
        TO.segment_or_rows(args[0][:2], *args[1:])
    monkeypatch.setattr(_build, "on_cpu", lambda tensors, what: False)
    with pytest.raises((RuntimeError, ValueError)):
        TO.segment_or_rows(*args)
    assert TSO.LAUNCHES == before
