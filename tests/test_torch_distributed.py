"""Port parity for the distributed placement: ``repro_torch``'s sharded
engine (sync and async) and distributed algorithms, run as 4 gloo ranks on
the CPU (``tests/_torch_dist_cases.py``, one pool for the module), held to
the live reference.

* Against the reference's *local* runs, in this process: BFS (push, pull
  / auto, the compacted push at capacities 16, the derived one and 0,
  async at K = 1, 2, 8), SSSP (sync and async), CC, ``msbfs`` (sync and
  async) and ``sssp_batched`` lanes, LPA, bit-equal; PageRank and SpMV
  (both modes) within 1e-5 (f32 sums in another order).
* Against the reference's *distributed* runs at 4 forced host devices
  (``tests/_ref_dist_runs.py``, its own process, started beside the
  ranks): iters / pushes / pulls / fallbacks and the trace rows of BFS
  auto, BFS push at capacity 16, SSSP, ``msbfs`` and async BFS at K = 2.
* Each level's collectives and routed bytes against ``traffic``'s model.

The graphs and cases mirror ``tests/_distributed_main.py``.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import algorithms as RA
from repro.core import graph as RG
from repro_torch.core import dgas as TD
from repro_torch.core import traffic
from repro_torch.core.algorithms import unshard_vertex_array
from repro_torch.launch import mesh as TM

import _torch_dist_cases as C

S = 4
HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5


def _local_reference() -> dict:
    """The reference's local results on the cases' inputs."""
    g = RG.rmat(8, 8, seed=1)
    gsym, gq = RA.symmetrize(g), RG.rmat(7, 8, seed=3)
    x = C.spmv_input(g.n_rows)
    return {"bfs": np.asarray(RA.bfs(g, 0)),
            "sssp": np.asarray(RA.sssp(g, 0, delta=0.5)),
            "cc": np.asarray(RA.connected_components(gsym,
                                                     symmetrize_input=False)),
            "lpa": np.asarray(RA.label_propagation(g, iters=5)),
            "pagerank": np.asarray(RA.pagerank(g, iters=15)),
            "spmv": np.asarray(RA.spmv(g, jnp.asarray(x))),
            "msbfs": np.asarray(RA.msbfs(gq, C.SOURCES)),
            "sssp_batched": np.asarray(RA.sssp_batched(gq, C.SOURCES,
                                                       delta=1.0))}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(port, ref_dist, local): rank 0's results of the port's cases, the
    reference's distributed runs (its own process) and its local results,
    made side by side."""
    tmp = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {part: subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_ref_dist_runs.py"),
         str(tmp / f"{part}.npz"), part], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for part in ("runs", "pagerank")}
    try:
        port = TM.spawn(C.run_cases, S, device="cpu",
                        init_file=str(tmp / "init"), timeout=300,
                        coll_timeout=120)[0]
        local = _local_reference()
    finally:
        logs = {part: p.communicate(timeout=300)[0]
                for part, p in procs.items()}
    ref = {}
    for part, p in procs.items():
        assert p.returncode == 0, logs[part]
        with np.load(tmp / f"{part}.npz") as z:
            ref.update({k: z[k] for k in z.files})
    return port, ref, local


@pytest.fixture(scope="module")
def runs(both):
    return both[:2]


@pytest.fixture(scope="module")
def local(both):
    return both[2]


def _global(port, name, att):
    return unshard_vertex_array(port["arrays"][name], att).numpy()


def _att(n):
    return TD.block_rule(n, S)


EXACT = {  # port case -> (reference local result, its vertex rule's n)
    "bfs/push": "bfs", "bfs/auto": "bfs", "bfs/cap_tiny": "bfs",
    "bfs/cap_derived": "bfs", "bfs/cap_disabled": "bfs", "sssp": "sssp",
    "cc": "cc", "lpa": "lpa",
    **{f"bfs/async{k}": "bfs" for k in C.ASYNC_K},
    **{f"sssp/async{k}": "sssp" for k in C.ASYNC_K},
}


@pytest.mark.parametrize("case", sorted(EXACT))
def test_bit_equal_to_local_reference(runs, local, case):
    port, _ = runs
    want = local[EXACT[case]]
    got = _global(port, case, _att(want.shape[0]))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["msbfs", "msbfs/async2", "sssp_batched"])
def test_lanes_bit_equal_to_local_reference(runs, local, case):
    port, _ = runs
    want = local[case.split("/")[0]]
    stacked = port["arrays"][case]                       # (S, B, per)
    att = _att(want.shape[1])
    for b in range(want.shape[0]):
        np.testing.assert_array_equal(
            unshard_vertex_array(stacked[:, b], att).numpy(), want[b])


@pytest.mark.parametrize("case", ["pagerank", "pagerank/balanced",
                                  "spmv/dgas", "spmv/allgather"])
def test_close_to_local_reference(runs, local, case):
    """f32 sums in another order: within 1e-5.  'pagerank/balanced' runs
    under the degree-balanced rule, whose shards have padding slots."""
    port, _ = runs
    g = RG.rmat(8, 8, seed=1)
    want = local[case.split("/")[0]]
    if case == "pagerank":
        att = _att(g.n_rows)
    else:
        att = TD.degree_balanced_rule(np.asarray(g.indptr), S)
    got = _global(port, case, att)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if case.startswith("pagerank"):
        assert abs(float(got.sum()) - 1.0) < 1e-4


def test_pagerank_keeps_padding_empty_where_the_reference_does_not(
        runs, local):
    """Under the degree-balanced rule the shards have padding slots.  The
    reference updates them like vertices, and as sinks they collect mass
    (its vector leaves the local PageRank, a fault of the reference); the
    port keeps them at 0 and holds the local result
    (``test_close_to_local_reference``)."""
    port, ref = runs
    g = RG.rmat(8, 8, seed=1)
    att = TD.degree_balanced_rule(np.asarray(g.indptr), S)
    assert S * att.per_shard > g.n_rows
    assert abs(float(ref["pagerank_balanced"].sum()) - 1.0) > 0.5
    port_rows = port["arrays"]["pagerank/balanced"]
    _, real = zip(*(att.resident(s, "cpu") for s in range(S)))
    assert not port_rows[~np.stack([r.numpy() for r in real])].any()


@pytest.mark.parametrize("run", ["bfs/auto", "bfs/cap_tiny", "sssp", "msbfs",
                                 "bfs/async2"])
def test_stats_and_trace_equal_reference_distributed(runs, run):
    port, ref = runs
    st = port["stats"][run]
    for k in ("iters", "pushes", "pulls", "fallbacks"):
        assert st[k] == int(ref[f"{run}|{k}"]), k
    np.testing.assert_array_equal(st["trace"], ref[f"{run}|trace"])
    if run == "bfs/cap_tiny":
        assert st["fallbacks"] > 0 and st["pushes"] == st["iters"]


@pytest.mark.parametrize("run", ["bfs/auto", "bfs/cap_tiny",
                                 "bfs/cap_derived", "bfs/cap_disabled",
                                 "sssp", "msbfs", "sssp_batched",
                                 "bfs/async2"])
def test_level_counts_match_traffic_model(runs, run):
    """Per level, the collectives this rank handed to the backend equal
    ``traffic.level_collectives``, a push level's routed bytes
    ``traffic.push_level_route_bytes`` at its capacity (the compacted one
    unless it fell back) with the payload it routes, a pull level's the
    dgas gather's three planes, a flush's ``flush_route_bytes``."""
    port, _ = runs
    st = port["stats"][run]
    assert len(st["levels"]) == st["pushes"] + st["pulls"]
    B = len(C.SOURCES)
    payload = {"msbfs": traffic.batched_payload_bytes(B, packed=True),
               "sssp_batched": traffic.batched_payload_bytes(B)}.get(
        run, traffic.ROUTE_PAYLOAD_BYTES)
    program = 2 if run.startswith("sssp") else 0
    for lv, row in zip(st["levels"], st["trace"]):
        assert (lv["push"], lv["fallback"]) == (row[1], row[2])
        routed = lv["bytes"]["all_to_all"]
        if run == "bfs/async2":
            assert lv["collectives"] == traffic.level_collectives(
                placement="async")
            assert routed == traffic.flush_route_bytes(S, st["m"], 4)
            continue
        assert lv["collectives"] == traffic.level_collectives(
            placement="sync", program_collectives=program)
        if not lv["push"]:
            assert routed == S * st["m_rev"] * (4 + 1 + 4)
            continue
        compacted = 0 < st["cap"] < st["m"] and not lv["fallback"]
        assert routed == traffic.push_level_route_bytes(
            S, st["cap"] if compacted else st["m"], payload)


def test_remote_scatter_or_interleave(runs):
    """At S = 4, ``remote_scatter_or`` under an interleave rule equals the
    plain OR of every rank's words."""
    port, _ = runs
    gidx, words = C.or_input(S)
    want = np.zeros((C.OR_N, C.OR_WORDS), np.int32)
    for s in range(S):
        for i in range(C.OR_ITEMS):
            want[gidx[s, i]] |= words[s, i]
    att = TD.interleave_rule(C.OR_N, S)
    np.testing.assert_array_equal(
        _global(port, "scatter_or", att), want)


@pytest.mark.parametrize("kind", ["interleave", "block"])
def test_routed_primitives_at_four_ranks(runs, kind):
    """``dgas_gather`` and ``all_gather_gather`` fetch the global table's
    rows, ``remote_scatter_add`` adds every rank's values at the owners
    (as ``tests/_distributed_main.py`` checks the reference)."""
    port, _ = runs
    table, gidx, aidx, avals = C.prim_input(S)
    att = getattr(TD, f"{kind}_rule")(C.PRIM_N, S)
    for name in ("dgas_gather", "all_gather_gather"):
        np.testing.assert_array_equal(port["arrays"][f"{name}/{kind}"],
                                      table[gidx])
    want = np.zeros(C.PRIM_N, np.float32)
    np.add.at(want, aidx.reshape(-1), avals.reshape(-1))
    np.testing.assert_allclose(_global(port, f"scatter_add/{kind}", att),
                               want, rtol=1e-5, atol=1e-5)


def test_prefix_scan_and_async_packed_lanes(runs):
    port, _ = runs
    np.testing.assert_array_equal(port["arrays"]["prefix_scan"].reshape(-1),
                                  [0, 3, 7, 12])
    np.testing.assert_array_equal(port["arrays"]["seen/async"],
                                  port["arrays"]["seen/sync"])


def test_ranks_ran_on_gloo(runs):
    port, _ = runs
    assert port["arrays"]["backend"] == "gloo"


def _live_children() -> set:
    """The pids of this process's children that have not exited."""
    out = set()
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as fh:
                stat = fh.read()
        except OSError:
            continue
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if int(ppid) == os.getpid() and state != "Z":
            out.add(int(d))
    return out


@pytest.mark.parametrize("bad", [-1, 1])
def test_spawn_leaves_no_process(tmp_path, bad):
    """After ``spawn`` returns or raises, no rank and no helper process
    it started is left running, also when one rank fails while the others
    wait in a collective."""
    before = _live_children()
    if bad < 0:
        got = TM.spawn(C.rank_or_fail, S, device="cpu",
                       init_file=str(tmp_path / "init"), args=(bad,),
                       timeout=120, coll_timeout=120)
        assert got == list(range(S))
    else:
        with pytest.raises(RuntimeError, match="fails on purpose"):
            TM.spawn(C.rank_or_fail, S, device="cpu",
                     init_file=str(tmp_path / "init"), args=(bad,),
                     timeout=120, coll_timeout=120)
    assert _live_children() <= before
    assert not (tmp_path / "init").exists()


def test_spawn_timeout_shows_every_rank_stack(tmp_path):
    """Past its timeout ``spawn`` raises with every live rank's stacks:
    rank 0 in the frame it blocks in, the others in the barrier that waits
    for it; and it leaves no process behind."""
    before = _live_children()
    with pytest.raises(RuntimeError, match="did not finish") as err:
        TM.spawn(C.block_past_timeout, S, device="cpu",
                 init_file=str(tmp_path / "init"), args=(600.0,),
                 timeout=20, coll_timeout=120)
    msg = str(err.value)
    parts = msg.split("rank ")[1:]
    stacks = {int(p.split()[0]): p for p in parts if " stacks:" in p[:12]}
    assert sorted(stacks) == list(range(S)), msg
    assert "wait_in_sleep" in stacks[0], msg
    for r in range(1, S):
        assert "in barrier" in stacks[r], msg
    assert _live_children() <= before
    assert not list(tmp_path.iterdir())
