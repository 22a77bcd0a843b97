"""The reference's distributed runs that ``tests/test_torch_distributed.py``
and ``tests/test_torch_dist_more.py`` hold the torch port to: run as its
own process (``python tests/_ref_dist_runs.py OUT.npz
{runs|pagerank|queue_louvain|service}``), since it forces 4 host devices
before JAX is imported.  'runs' writes per run the engine's iters /
pushes / pulls / fallbacks and the level trace, rank 0's copy (every shard
holds the same); 'pagerank' the reference's distributed PageRank under the
degree-balanced rule; 'queue_louvain' ``queue_balance`` and
``modularity_distributed`` on the inputs of ``tests/_torch_dist_cases.py``;
'service' the distributed ``GraphService``, sync and async, on its stream
(the tests start the parts as processes, side by side)."""
# The script drives the reference from the host and reads every result
# back to save it; its one traced function is queue_louvain's `bal`, which
# makes the lint treat the whole module as traced.
# repro-lint: disable-file=host-sync
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

from repro.core import dgas, engine, rmat  # noqa: E402
from repro.core.algorithms.bfs import (bfs_level_program, bfs_program,  # noqa: E402
                                       msbfs_distributed)
from repro.core.algorithms.distgraph import (shard_graph,  # noqa: E402
                                             unshard_vertex_array)
from repro.core.algorithms.pagerank import pagerank_distributed  # noqa: E402
from repro.core.algorithms.sssp import sssp_program  # noqa: E402
from repro.launch.mesh import make_cores_mesh  # noqa: E402

S = 4
CAP_TINY = 16
SOURCES = np.array([0, 5, 33, 64, 100, 127], np.int32)
KEYS = ("iters", "pushes", "pulls", "fallbacks", "trace")


def pagerank_balanced(path: str) -> None:
    """PageRank under the degree-balanced rule, whose shards have padding
    slots."""
    mesh = make_cores_mesh(S)
    g = rmat(8, 8, seed=1)
    gsh, att = shard_graph(g, S)
    pr = pagerank_distributed(gsh, att, mesh, axis="cores", iters=15)
    np.savez(path, pagerank_balanced=np.asarray(unshard_vertex_array(pr,
                                                                     att)))


def main(path: str) -> None:
    mesh = make_cores_mesh(S)
    g = rmat(8, 8, seed=1)
    att = dgas.block_rule(g.n_rows, S)
    gsh, _ = shard_graph(g, S, row_att=att)
    g_rev = engine.reverse_graph(g, att)
    per = att.per_shard
    owner, local = int(att.owner(jnp.asarray(0))), int(att.local(jnp.asarray(0)))
    f0 = jnp.zeros((S, per), jnp.int32).at[owner, local].set(1)
    st0 = {"level": jnp.full((S, per), -1, jnp.int32).at[owner, local].set(0)}
    dist0 = jnp.full((S, per), jnp.inf).at[owner, local].set(0.0)
    runs = {}
    kw = dict(axis="cores", return_stats=True, trace=True)
    runs["bfs/auto"] = engine.run_distributed(
        gsh, att, mesh, bfs_program(), st0, f0, max_iters=64, g_rev=g_rev,
        mode="auto", **kw)[1]
    runs["bfs/cap_tiny"] = engine.run_distributed(
        gsh, att, mesh, bfs_program(), st0, f0, max_iters=64, mode="push",
        push_edge_capacity=CAP_TINY, **kw)[1]
    runs["bfs/async2"] = engine.run_distributed(
        gsh, att, mesh, bfs_level_program(), {"dist": dist0}, f0,
        max_iters=128, mode="push", placement="async", sync_interval=2,
        **kw)[1]
    prog = sssp_program(0.5, global_min=lambda x: lax.pmin(x, "cores"))
    state0 = {"dist": dist0, "pending": f0 > 0,
              "bound": jnp.full((S, 1), 0.5, jnp.float32)}
    runs["sssp"] = engine.run_distributed(
        gsh, att, mesh, prog, state0, f0, max_iters=256, mode="push",
        **kw)[1]
    gq = rmat(7, 8, seed=3)
    att_q = dgas.block_rule(gq.n_rows, S)
    gsh_q, _ = shard_graph(gq, S, row_att=att_q)
    runs["msbfs"] = msbfs_distributed(gsh_q, att_q, SOURCES, mesh,
                                      return_stats=True, trace=True)[1]
    np.savez(path, **{f"{name}|{k}": np.asarray(st[k])[0]
                      for name, st in runs.items() for k in KEYS})


def queue_louvain(path: str) -> None:
    """queue_balance on the cases' queues; modularity_distributed of the
    cases' labeling on both Louvain graphs."""
    from repro.compat import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.core import offload
    from repro.core.algorithms.louvain import modularity_distributed
    from repro.core.algorithms.distgraph import shard_vertex_array
    from repro.core.graph import CSR
    import _torch_dist_cases as C
    mesh = make_cores_mesh(S)
    spec = P("cores")
    items, counts, pay = C.queue_input(S)

    def bal(it, ct, pl):
        q, p = offload.queue_balance(offload.QueueState(it[0], ct[0, 0]),
                                     "cores", pl[0])
        return q.items[None], q.count[None, None], p[None]

    fn = shard_map(bal, mesh=mesh, in_specs=(spec,) * 3,
                   out_specs=(spec,) * 3)
    qi, qc, qp = fn(jnp.asarray(items), jnp.asarray(counts)[:, None],
                    jnp.asarray(pay))
    out = {"queue/items": np.asarray(qi), "queue/count": np.asarray(qc),
           "queue/payload": np.asarray(qp)}
    for integer in (True, False):
        tag = "int" if integer else "f32"
        indptr, indices, vals, n = C.louvain_graph(integer)
        rows = np.repeat(np.arange(n), np.diff(indptr))
        g = CSR.from_coo(rows, indices, vals, n, n)
        att = dgas.block_rule(n, S)
        gsh, _ = shard_graph(g, S, row_att=att)
        lab = shard_vertex_array(C.louvain_labels(n), att)
        out[f"louvain/{tag}/q"] = np.asarray(modularity_distributed(
            gsh, att, mesh, lab, axis="cores"))
    np.savez(path, **out)


def service(path: str) -> None:
    """The distributed service, sync and async, on the cases' stream."""
    from repro.core import service as RS
    import _torch_dist_cases as C
    mesh = make_cores_mesh(S)
    g = rmat(7, 8, seed=3)
    out = {}
    for placement in ("sync", "async"):
        svc = RS.GraphService(g, batch_budget=C.SVC_BUDGET, mesh=mesh,
                              placement=placement, sync_interval=C.SVC_K)
        res = C.run_service(svc, g.n_rows, RS)
        out.update({f"service/{placement}/{k}": np.asarray(v)
                    for k, v in res.items()})
    np.savez(path, **out)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    {"runs": main, "pagerank": pagerank_balanced,
     "queue_louvain": queue_louvain, "service": service}[sys.argv[2]](
        sys.argv[1])
