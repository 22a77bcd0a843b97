"""Port parity for streaming repair: ``repro_torch``'s ``bfs_repair``,
``cc_repair``, ``sssp_repair`` and ``repair_or_recompute`` over
``GraphHandle.apply``.

Bit-equal: the golden update stream (``tests/golden/streaming.npz``,
replayed epoch by epoch), and repair after random insert batches against
from-scratch runs of the live reference on the same updated graph.  A
batch with deletes takes the full-recompute fallback, which the port's
registry counts once per kind.
"""
import os

import numpy as np
import pytest
import torch

from repro.core import algorithms as RA
from repro.core import graph as RG
from repro_torch.core import algorithms as TA
from repro_torch.core import graph as TG
from repro_torch.obs import get_registry
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "streaming.npz")
KINDS = ("bfs", "cc", "sssp")


def _host(t):
    return t.numpy()


def test_golden_streaming_replay():
    data = np.load(GOLDEN)
    scale, ef, seed, n_epochs, source = data["meta"].tolist()
    ctr = get_registry().counter("streaming.full_recompute_fallback")
    c0 = ctr.value
    handle = TG.GraphHandle.wrap(TG.rmat(scale, ef, seed=seed, device="cpu"),
                                 n_partitions=8)
    np.testing.assert_array_equal(_host(TA.bfs(handle.csr, source)),
                                  data["epoch0/bfs"])
    prev = {k: torch.from_numpy(data[f"epoch0/{k}"]) for k in KINDS}
    unsafe = 0
    for e in range(1, n_epochs + 1):
        handle, rep = handle.apply(
            (data[f"epoch{e}/ins_r"], data[f"epoch{e}/ins_c"],
             data[f"epoch{e}/ins_v"]),
            (data[f"epoch{e}/del_r"], data[f"epoch{e}/del_c"]))
        assert rep.monotone_safe == bool(data[f"epoch{e}/monotone_safe"][0])
        unsafe += not rep.monotone_safe
        for kind in KINDS:
            got = TA.repair_or_recompute(kind, handle, prev[kind], rep,
                                         source=source)
            want = data[f"epoch{e}/{kind}"]
            assert got.numpy().dtype == want.dtype
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"epoch {e} {kind}")
            prev[kind] = got
    assert ctr.value - c0 == 3 * unsafe


@pytest.mark.parametrize("seed", [0, 1])
def test_repair_equals_reference_scratch(seed):
    """Two random insert batches (new edges and weight decreases) on
    uniform and RMAT graphs: each repair equals the live reference's
    from-scratch bfs / connected_components / sssp on the updated graph."""
    rng = np.random.default_rng(seed)
    g = (RG.uniform_random_graph(96, 3, seed=5) if seed else
         RG.rmat(7, 6, seed=13))
    n = g.n_rows
    port = TG.csr_from_numpy(np.asarray(g.indptr), np.asarray(g.indices),
                             np.asarray(g.values), n, n, device="cpu")
    th, rh = TG.GraphHandle.wrap(port), RG.GraphHandle.wrap(g)
    delta = 0.05
    prev = {"bfs": TA.bfs(th.csr, 0), "cc": TA.connected_components(th.csr),
            "sssp": TA.sssp(th.csr, 0, delta=delta)}
    for _ in range(2):
        k = int(rng.integers(5, 30))
        ins = (rng.integers(0, n, k), rng.integers(0, n, k),
               rng.uniform(1e-4, 1e-3, k).astype(np.float32))
        th, rep = th.apply(ins)
        rh, rrep = rh.apply(ins)
        assert rep.monotone_safe and rrep.monotone_safe
        r = rh.csr
        want = {"bfs": RA.bfs(r, 0), "cc": RA.connected_components(r),
                "sssp": RA.sssp(r, 0, delta=delta)}
        for kind in KINDS:
            got = TA.repair_or_recompute(kind, th, prev[kind], rep, source=0)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want[kind]),
                                          err_msg=kind)
            prev[kind] = got
    np.testing.assert_array_equal(
        TA.bfs_repair(th.csr, prev["bfs"], np.zeros(0, np.int64)).numpy(),
        prev["bfs"].numpy())


def test_deletes_fall_back_and_count(caplog):
    g = TG.uniform_random_graph(50, 3, seed=14, device="cpu")
    handle = TG.GraphHandle.wrap(g)
    prev = {"bfs": TA.bfs(handle.csr, 0),
            "cc": TA.connected_components(handle.csr),
            "sssp": TA.sssp(handle.csr, 0)}
    r, c = int(g.row_ids()[0]), int(g.indices[0])
    handle, rep = handle.apply(deletes=(np.array([r]), np.array([c])))
    assert not rep.monotone_safe and rep.n_deleted == 1
    ctr = get_registry().counter("streaming.full_recompute_fallback")
    csr = handle.csr
    scratch = {"bfs": TA.bfs(csr, 0), "cc": TA.connected_components(csr),
               "sssp": TA.sssp(csr, 0)}
    for kind in KINDS:
        c0 = ctr.value
        with caplog.at_level("INFO", logger="repro_torch.streaming"):
            got = TA.repair_or_recompute(kind, handle, prev[kind], rep)
        assert ctr.value == c0 + 1
        assert torch.equal(got, scratch[kind])
    assert sum("full recompute fallback" in m for m in caplog.messages) == 3
    with pytest.raises(ValueError, match="kind"):
        TA.repair_or_recompute("pagerank", handle, None, rep)
