"""Port parity for the second half of the distributed placement, run as
4 gloo ranks on the CPU laid out as a (2, 2) grid
(``tests/_torch_dist_cases.py`` ``run_more_cases``, one pool for the
module; the 1-D mesh of 4 is the grid's flattened world), held to the live
reference and to the port's local results.

* Against the reference's distributed runs at 4 forced host devices
  (``tests/_ref_dist_runs.py`` 'queue_louvain' and 'service', two
  processes started beside the ranks): ``queue_balance``'s items and
  payload bit-equal; ``modularity_distributed`` within 1e-5; the
  distributed ``GraphService``, sync and async, with equal answers
  (Distance exact), batches, cache hits and route bytes.  Its deadline
  admission (one collective per flush opportunity) answers as the local
  service does, and calls that diverge between ranks fail on every rank.
* Against the reference in this process (host-side numpy code):
  ``contract_distributed``'s coarse shards, renumbering and routed count
  equal, and the host ``update_shards`` bit-equal, overflow included.
* Against the port's local results: distributed walks bit-equal to
  ``random_walks``, through the entry point and through ``run_queue`` at
  another balancing cadence; ``multilevel_distributed``'s
  partition equal to ``multilevel``'s with Q within 1e-5; both repairs
  bit-equal to the local repairs and to fresh distributed runs; the
  rank-form ``update_shards`` equal to the host form; the service equal to
  the local service; BFS / SSSP over the grid's tuple axis equal to the
  local runs, and ``hierarchical_psum`` over the two axes equal to the
  world's sum.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dgas as RD
from repro.core import graph as RG
from repro.core.algorithms import distgraph as RDG
from repro.core.algorithms import louvain as RL
from repro_torch.core import algorithms as TA
from repro_torch.core import dgas as TD
from repro_torch.core import service as TS
from repro_torch.core import traffic
from repro_torch.core.graph import GraphHandle, csr_from_numpy, rmat
from repro_torch.launch import mesh as TM

import _torch_dist_cases as C

S = 4
HERE = os.path.dirname(os.path.abspath(__file__))
PARTS = ("queue_louvain", "service")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port, ref): rank 0's results of the port's cases and the
    reference's distributed runs (two processes), made side by side."""
    tmp = tmp_path_factory.mktemp("dist_more")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {part: subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_ref_dist_runs.py"),
         str(tmp / f"{part}.npz"), part], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for part in PARTS}
    try:
        port = TM.spawn(C.run_more_cases, S, device="cpu",
                        init_file=str(tmp / "init"), grid=C.GRID,
                        timeout=300, coll_timeout=120)[0]
    finally:
        logs = {part: p.communicate(timeout=300)[0]
                for part, p in procs.items()}
    ref = {}
    for part, p in procs.items():
        assert p.returncode == 0, logs[part]
        with np.load(tmp / f"{part}.npz") as z:
            ref.update({k: z[k] for k in z.files})
    return port, ref


def _global(arr, n):
    return TA.unshard_vertex_array(arr, TD.block_rule(n, S)).numpy()


def _graph():
    return rmat(7, 8, seed=3, device="cpu")


def test_queue_balance_bit_equal_to_reference(runs):
    port, ref = runs
    np.testing.assert_array_equal(port["queue/items"], ref["queue/items"])
    np.testing.assert_array_equal(port["queue/count"].reshape(-1),
                                  ref["queue/count"].reshape(-1))
    assert port["queue/payload"].tobytes() == ref["queue/payload"].tobytes()
    counts = port["queue/count"].reshape(-1)
    assert counts.sum() == sum(C.QUEUE_COUNTS) and np.ptp(counts) <= 1


@pytest.mark.parametrize("k", C.WALK_K)
def test_walks_bit_equal_to_local(runs, k):
    """Walker w's step t is keyed on (w, t) in both forms, so the walks do
    not depend on the rank a walker sits on or on the cadence (k 1: the
    entry point ``random_walks_distributed``; k 3: ``run_queue`` driven
    with ``walk_queue_program``)."""
    port, _ = runs
    g = _graph()
    want = TA.random_walks(g, torch.arange(g.n_rows), C.WALK_STEPS,
                           C.WALK_KEY)
    np.testing.assert_array_equal(port[f"walks/k{k}"], want.numpy())


def _louvain_csrs(integer):
    indptr, indices, vals, n = C.louvain_graph(integer)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    return (RG.CSR.from_coo(rows, indices, vals, n, n),
            csr_from_numpy(indptr, indices, vals, n, n, device="cpu"))


@pytest.mark.parametrize("tag", ["int", "f32"])
def test_modularity_within_1e5(runs, tag):
    port, ref = runs
    q = port[f"louvain/{tag}/q"].reshape(-1)
    assert np.all(q == q[0])                     # the same on every rank
    assert abs(float(q[0]) - float(ref[f"louvain/{tag}/q"].reshape(-1)[0])) \
        <= 1e-5
    _, t = _louvain_csrs(tag == "int")
    local = float(TA.modularity(t, torch.from_numpy(
        C.louvain_labels(t.n_rows))))
    assert abs(float(q[0]) - local) <= 1e-5


@pytest.mark.parametrize("tag", ["int", "f32"])
def test_contract_equals_reference(runs, tag):
    """The coarse shards (the reference's host repartition), the dense
    renumbering and the routed count are equal; the counter charges the
    routed edges."""
    port, _ = runs
    r, _ = _louvain_csrs(tag == "int")
    att = RD.block_rule(r.n_rows, S)
    gsh, _ = RDG.shard_graph(r, S, row_att=att)
    _, cg, _, dense, n_routed = RL.contract_distributed(
        gsh, att, jnp.asarray(C.louvain_labels(r.n_rows)))
    for f in ("src", "dst", "val"):
        np.testing.assert_array_equal(port[f"louvain/{tag}/coarse_{f}"],
                                      np.asarray(getattr(cg, f)), f)
    np.testing.assert_array_equal(port[f"louvain/{tag}/renumber"],
                                  np.asarray(dense))
    routed, charged = port[f"louvain/{tag}/routed"]
    assert routed == n_routed and n_routed > 0
    assert charged == n_routed * traffic.CONTRACT_PAYLOAD_BYTES


@pytest.mark.parametrize("tag", ["int", "f32"])
def test_multilevel_equals_local(runs, tag):
    """Integer weights: the partition and scores of the local run.  Float
    weights: Q within 1e-5; on this graph no vertex's community differs
    either (the gain gate's in-side sums add in the local order)."""
    port, _ = runs
    _, t = _louvain_csrs(tag == "int")
    labels, scores = TA.multilevel(t)
    got = torch.from_numpy(port[f"louvain/{tag}/ml"])
    assert len(scores) >= 2
    np.testing.assert_allclose(port[f"louvain/{tag}/ml_scores"], scores,
                               rtol=0, atol=1e-5)
    assert abs(float(TA.modularity(t, got)) - scores[-1]) <= 1e-5
    if tag == "int":
        np.testing.assert_array_equal(port[f"louvain/{tag}/ml_scores"],
                                      scores)
    differ = float((got != labels).float().mean())
    assert TA.partition_equal(got, labels), differ


def _updated(edges):
    g = _graph()
    h, rep = GraphHandle.wrap(g, n_partitions=S).apply(edges)
    att = TD.block_rule(g.n_rows, S)
    shards = np.unique(att.owner(torch.as_tensor(
        rep.changed_sources)).numpy())
    return g, h.csr, rep, shards


def _ref_csr(t):
    return RG.CSR(jnp.asarray(t.indptr.numpy()), jnp.asarray(t.indices.numpy()),
                  jnp.asarray(t.values.numpy()), t.n_rows, t.n_cols)


@pytest.mark.parametrize("case", ["small", "overflow"])
def test_update_shards_host_bit_equal_to_reference(case):
    edges = C.UPDATE_SMALL if case == "small" else C.update_big(128, S)
    g, new, _, shards = _updated(edges)
    t_att, r_att = TD.block_rule(g.n_rows, S), RD.block_rule(g.n_rows, S)
    t_gsh, _ = TA.shard_graph(g, S, row_att=t_att)
    r_gsh, _ = RDG.shard_graph(_ref_csr(g), S, row_att=r_att)
    want = RDG.update_shards(r_gsh, _ref_csr(new), r_att, shards)
    got = TA.update_shards(t_gsh, new, t_att, shards)
    if case == "overflow":
        assert want is None and got is None
        return
    assert got.n_shards == S and got.n_vertices == g.n_rows
    for f in ("src", "dst", "val"):
        assert getattr(got, f).numpy().tobytes() == \
            np.asarray(getattr(want, f)).tobytes(), f
    untouched = [s for s in range(S) if s not in shards]
    assert untouched and torch.equal(got.src[untouched],
                                     t_gsh.src[untouched])


def test_update_shards_on_ranks(runs):
    """Each rank's rebuilt shard equals the host form's row; an overflow
    returns None on every rank, counted once per rank."""
    port, _ = runs
    g, new, _, shards = _updated(C.UPDATE_SMALL)
    host = TA.update_shards(TA.shard_graph(g, S, row_att=TD.block_rule(
        g.n_rows, S))[0], new, TD.block_rule(g.n_rows, S), shards)
    for f in ("src", "dst", "val"):
        np.testing.assert_array_equal(port[f"update/{f}"],
                                      getattr(host, f).numpy())
    assert bool(port["update/big_none"][0])
    assert int(port["update/fallbacks"][0]) == 1
    # rank 0's shard was not touched: it keeps its shard as it was
    assert 0 not in shards and bool(port["update/same_object"][0])


def test_repairs_bit_equal_to_local_and_fresh(runs):
    port, _ = runs
    g, new, rep, _ = _updated(C.UPDATE_SMALL)
    n = g.n_rows
    want_bfs = TA.bfs_repair(new, TA.bfs(g, 0), rep.changed_sources)
    np.testing.assert_array_equal(want_bfs.numpy(), TA.bfs(new, 0).numpy())
    for name in ("repair/bfs", "repair/bfs_async", "fresh/bfs"):
        np.testing.assert_array_equal(_global(port[name], n),
                                      want_bfs.numpy(), name)
    want_cc = TA.cc_repair(new, TA.connected_components(g),
                           rep.changed_vertices)
    for name in ("repair/cc", "fresh/cc"):
        np.testing.assert_array_equal(_global(port[name], n),
                                      want_cc.numpy(), name)


@pytest.mark.parametrize("placement", ["sync", "async"])
def test_service_equals_reference_and_local(runs, placement):
    """The same answers as the reference's distributed service (Distance
    exact) and as the port's local one; the same batches and cache hits,
    and the route-byte ledger priced alike from the levels."""
    port, ref = runs
    key = f"service/{placement}"
    np.testing.assert_array_equal(port[f"{key}/answers"],
                                  ref[f"{key}/answers"])
    for k in ("batches", "hits", "route_bytes"):
        assert int(port[f"{key}/{k}"]) == int(ref[f"{key}/{k}"]), k
    local = C.run_service(TS.GraphService(_graph(), batch_budget=C.SVC_BUDGET,
                                          n_model_shards=S), 128, TS)
    np.testing.assert_array_equal(port[f"{key}/answers"], local["answers"])


def test_mesh_service_deadline_admission(runs):
    """Zero-deadline queries flush at each submit on the mesh as locally:
    the same answers and batches, for one admission collective per
    submit and one for the closing flush (none locally)."""
    port, _ = runs
    local_svc = TS.GraphService(_graph(), batch_budget=C.SVC_BUDGET,
                                n_model_shards=S)
    local = C.run_deadline_service(local_svc, 128, TS)
    np.testing.assert_array_equal(port["service/deadline/answers"],
                                  local["answers"])
    assert int(port["service/deadline/batches"]) == local["batches"] > 1
    assert int(port["service/deadline/admissions"]) == \
        C.DEADLINE_QUERIES + 1
    assert local["admissions"] == 0


def test_mesh_service_divergence_fails_on_every_rank(runs):
    port, _ = runs
    assert port["service/diverged_raises"].reshape(-1).tolist() == [1] * S


def test_grid_tuple_axes_equal_the_world(runs):
    port, _ = runs
    g = _graph()
    np.testing.assert_array_equal(_global(port["grid/bfs"], g.n_rows),
                                  TA.bfs(g, 0).numpy())
    np.testing.assert_array_equal(_global(port["grid/sssp"], g.n_rows),
                                  TA.sssp(g, 0, delta=0.5).numpy())
    x = np.array([[r + 1.0, 10.0 * (r + 1)] for r in range(S)], np.float32)
    for name in ("grid/hpsum", "grid/hpsum_meshes", "grid/psum_1d"):
        np.testing.assert_array_equal(port[name], np.tile(x.sum(0), (S, 1)),
                                      name)
    # rank = 2 * data + model: 'data' sums ranks {r, r ^ 2}, 'model' {r, r ^ 1}
    for name, other in (("grid/data", 2), ("grid/model", 1)):
        want = np.stack([x[r] + x[r ^ other] for r in range(S)])
        np.testing.assert_array_equal(port[name], want, name)
