"""B4's CSR form on the CPU: the plan (``segment_sum.SegmentPlan``) against
numpy's stable ``argsort`` and ``bincount``; the plain version
``ref.segment_sum_csr_ref`` against ``jax.ops.segment_sum`` of the gathered
rows; the CUDA kernel's two passes walked group by group in numpy
(:func:`_walk`, a line-for-line mirror of ``csrc/segment_sum.cu``: a change
to the kernel's walk must be made here too) against the plain version and,
bit for bit, against ``ref.segment_sum_pieces_ref``, the order the card
tests hold the kernel to; and GIN's fused gather-and-sum
(``gnn.gather_segment_sum``) and its VJP against the reference's
``gather_nodes(...) * valid`` and ``scatter_add_nodes`` under ``jax.vjp``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.distributed.sharding import make_rules
from repro.models import gnn as RGNN
from repro_torch.kernels import ref
from repro_torch.kernels import segment_sum as SS
from repro_torch.models import gnn as G
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

KUNROLL = 8          # csrc/segment_sum.cu kUnroll


def _streams(case, rng):
    """(seg, n) of each case: -1 and ids >= n, sorted with its padding at
    the tail, sorted with -1 first, empty segments, one hub segment."""
    n = 30
    if case == "random":
        return rng.integers(-2, n + 3, 400), n
    if case == "sorted_tail_pad":
        seg = np.sort(rng.integers(0, n, 300))
        return np.concatenate([seg, np.full(40, -1)]), n
    if case == "sorted_head_pad":
        return np.sort(rng.integers(-1, n, 300)), n
    if case == "empty_rows":
        return rng.choice([2, 5, 6, 29], 200), n
    if case == "hub":
        seg = np.where(rng.random(600) < 0.7, 7, rng.integers(0, n, 600))
        return seg, n
    raise ValueError(case)


CASES = ["random", "sorted_tail_pad", "sorted_head_pad", "empty_rows", "hub"]


@pytest.mark.parametrize("case", CASES)
def test_plan_matches_numpy_stable_sort_and_bincount(case):
    rng = np.random.default_rng(CASES.index(case))
    seg, n = _streams(case, rng)
    seg = seg.astype(np.int32)
    plan = SS.SegmentPlan(torch.from_numpy(seg), n)
    keep = (seg >= 0) & (seg < n)
    keys = np.where(keep, seg, n)
    want_off = np.concatenate([[0], np.cumsum(np.bincount(seg[keep],
                                                          minlength=n))])
    np.testing.assert_array_equal(plan.offsets.numpy(), want_off)
    assert plan.offsets.dtype == torch.int64
    if plan.perm is None:            # in order already: no sort
        assert (np.diff(keys) >= 0).all()
        order = np.arange(seg.size)
    else:
        assert plan.perm.dtype == torch.int32
        order = plan.perm.numpy()
        np.testing.assert_array_equal(order, np.argsort(keys, kind="stable"))
    assert (plan.perm is None) == (case == "sorted_tail_pad")
    # every segment's run holds exactly its ids, in stream order
    for s in range(n):
        run = order[want_off[s]:want_off[s + 1]]
        assert (seg[run] == s).all() and (np.diff(run) > 0).all()


@pytest.mark.parametrize("gathered", [False, True])
def test_csr_ref_matches_jax_segment_sum(gathered):
    rng = np.random.default_rng(3)
    t, e, m, d = 50, 500, 40, 6
    table = rng.standard_normal((t, d)).astype(np.float32)
    off = np.sort(rng.integers(0, e, m + 1))
    off[0], off[-1] = 0, e if gathered else t
    rows = rng.integers(-3, t + 4, e).astype(np.int32) if gathered else None
    j = np.arange(off[0], off[-1])
    seg = np.searchsorted(off, j, side="right") - 1
    ids = j if rows is None else rows[j]
    ok = (ids >= 0) & (ids < t)
    msg = np.where(ok[:, None], table[np.clip(ids, 0, t - 1)], 0)
    want = jax.ops.segment_sum(jnp.asarray(msg), jnp.asarray(seg),
                               num_segments=m)
    got = ref.segment_sum_csr_ref(
        torch.from_numpy(table), torch.from_numpy(off),
        None if rows is None else torch.from_numpy(rows))
    assert got.dtype == torch.float32 and got.shape == (m, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _walk(table, off, rows, share):
    """``segment_sum_csr`` of csrc/segment_sum.cu, one group (share) at a
    time: pass 1 (segment_sum_rows) then pass 2 (segment_sum_fix), in f32
    over all columns at once.  Rows and scratch start as NaN, so a row the
    kernel would not write shows."""
    m, (t, d) = off.size - 1, table.shape
    base = int(off[0])
    total = m + int(off[m]) - base
    entries = t if rows is None else rows.size
    n_groups = max(1, -(-(m + entries) // share))
    out = np.full((m, d), np.nan, np.float32)
    part = np.full((n_groups, 2, d), np.nan, np.float32)
    tail = np.full(n_groups, -7)

    def find_row(k):
        lo, hi = 0, m
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if mid + off[mid] - base <= k:
                lo = mid
            else:
                hi = mid - 1
        return lo

    for g in range(n_groups):
        k0 = g * share
        if k0 >= total:
            tail[g] = -1
            continue
        k1 = min(k0 + share, total)
        r0, r1 = find_row(k0), find_row(k1)
        j0, j1 = base + k0 - r0, base + k1 - r1
        cont = j0 > off[r0]
        st = {"acc": np.zeros(d, np.float32), "r": r0}

        def emit():
            r = st["r"]
            if r == r0 and cont:
                part[g, 0] = st["acc"]
            else:
                out[r] = st["acc"]
            st["acc"] = np.zeros(d, np.float32)
            st["r"] = r + 1

        j, row_end = j0, off[r0 + 1]
        while True:
            while st["r"] < r1 and row_end <= j:
                emit()
                row_end = off[st["r"] + 1] if st["r"] < m else 0
            if j >= j1:
                break
            n = min(KUNROLL, j1 - j)
            xs = []
            for u in range(n):
                i = j + u if rows is None else int(rows[j + u])
                xs.append(table[i] if 0 <= i < t else np.zeros(d, np.float32))
            for u in range(n):
                while row_end <= j + u:
                    emit()
                    row_end = off[st["r"] + 1]
                st["acc"] = st["acc"] + xs[u]
            j += n
        assert st["r"] == r1
        tailed = False
        if r1 < m and j1 > max(j0, off[r1]):
            middle = r1 == r0 and cont
            part[g, 0 if middle else 1] = st["acc"]
            tailed = not middle
        tail[g] = r1 if tailed else -1
    for g in range(n_groups):
        r = tail[g]
        if r < 0:
            continue
        last = (r + off[r + 1] - base) // share
        acc = part[g, 1]
        for h in range(g + 1, last + 1):
            acc = acc + part[h, 0]
        out[r] = acc
    return out


@pytest.mark.parametrize("block_n", [1, 2, 5, 16, 64, 4096])
@pytest.mark.parametrize("gathered", [False, True])
def test_kernel_walk_equals_pieces_and_plain_version(block_n, gathered):
    """Hub rows of 150 and 90 entries, empty rows, dropped ids and a
    first offset past 0: every row written once; the walk's bits are
    segment_sum_pieces_ref's; within 1e-5 of the float64 plain version."""
    rng = np.random.default_rng(block_n)
    t, d = 60, 3
    lengths = rng.integers(0, 4, 40)
    lengths[[5, 30]] = (150, 90)
    lengths[[0, 11, 39]] = 0
    off = np.concatenate([[0], np.cumsum(lengths)]) + 4
    e = int(off[-1]) + 3
    table = rng.standard_normal((e if not gathered else t, d)).astype(
        np.float32)
    rows = rng.integers(-2, t + 2, e).astype(np.int32) if gathered else None
    got = _walk(table, off, rows, block_n)
    args = (torch.from_numpy(table), torch.from_numpy(off),
            None if rows is None else torch.from_numpy(rows))
    want = ref.segment_sum_pieces_ref(*args, block_n=block_n)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_allclose(got, ref.segment_sum_csr_ref(*args).numpy(),
                               rtol=1e-5, atol=1e-5)
    split = SS.split_rows(torch.from_numpy(off), block_n)
    assert (split >= 2) if block_n <= 64 else split == 0


def test_gather_segment_sum_matches_reference_and_its_vjp():
    """GIN's message passing on a graph of 150 vertices with padded edges
    (src and dst -1) and edges whose dst is -1: forward and the VJP with
    respect to x, one EdgePlan reused for a second call."""
    rng = np.random.default_rng(4)
    n, e, d = 150, 900, 5
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    dst[rng.random(e) < 0.05] = -1
    src[-60:] = dst[-60:] = -1
    x = rng.standard_normal((n, d)).astype(np.float32)
    cot = rng.standard_normal((n, d)).astype(np.float32)
    rcfg, rules = ref_config("gin-tu").smoke, make_rules(None)
    js, jd = jnp.asarray(src), jnp.asarray(dst)

    def f(xx):
        msg = RGNN.gather_nodes(rcfg, xx, js, rules) * (js >= 0)[:, None]
        return RGNN.scatter_add_nodes(rcfg, n, jnp.where(js >= 0, jd, -1),
                                      msg, rules)
    want, vjp = jax.vjp(f, jnp.asarray(x))
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    plan = G.EdgePlan(ts, td, n, n)
    for _ in range(2):
        tx = torch.from_numpy(x).requires_grad_(True)
        got = G.gather_segment_sum(tx, ts, td, n, plan)
        got.backward(torch.from_numpy(cot))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(vjp(
            jnp.asarray(cot))[0]), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="plan"):
        G.gather_segment_sum(torch.from_numpy(x), ts, td, n + 1, plan)
