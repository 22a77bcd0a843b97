"""The reference's distributed runs that ``tests/test_torch_distributed.py``
holds the torch port's stats and trace rows to: run as its own process
(``python tests/_ref_dist_runs.py OUT.npz {runs|pagerank}``), since it
forces 4 host devices before JAX is imported.  'runs' writes per run the
engine's iters / pushes / pulls / fallbacks and the level trace, rank 0's
copy (every shard holds the same); 'pagerank' the reference's distributed
PageRank under the degree-balanced rule (the test starts the two parts
as two processes, side by side)."""
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


if __name__ == "__main__":
    {"runs": main, "pagerank": pagerank_balanced}[sys.argv[2]](sys.argv[1])
