"""Rank side of ``tests/test_torch_distributed.py``: the distributed cases
of the torch port, run on every rank of a 4-rank gloo mesh.

Imported by the spawned ranks (torch and ``repro_torch`` only, no JAX).
:func:`run_cases` runs every case on one mesh and returns, on rank 0, a
dict of numpy arrays in the reference's stacked (S, per, ...) layout, and
the stats and per-level collective counts of the runs the test holds to
the reference's distributed runs.  The graphs and cases mirror
``tests/_distributed_main.py``.
"""
import numpy as np
import torch

from repro_torch.core import dgas, engine, offload
from repro_torch.core import algorithms as A
from repro_torch.core.algorithms.bfs import source_rows
from repro_torch.core.algorithms.distgraph import shard_graph
from repro_torch.core.graph import rmat

CAP_TINY = 16                         # forces compaction fallbacks
ASYNC_K = (1, 2, 8)
SOURCES = np.array([0, 5, 33, 64, 100, 127], np.int32)
OR_N, OR_ITEMS, OR_WORDS = 64, 16, 2


def graphs():
    """The cases' graphs on the CPU: rmat(8, 8, seed=1) and its
    symmetrization, rmat(7, 8, seed=3)."""
    g = rmat(8, 8, seed=1, device="cpu")
    return g, A.symmetrize(g), rmat(7, 8, seed=3, device="cpu")


def spmv_input(n: int) -> np.ndarray:
    return np.random.default_rng(0).random(n).astype(np.float32)


def or_input(S: int):
    rng = np.random.default_rng(1)
    gidx = rng.integers(0, OR_N, (S, OR_ITEMS)).astype(np.int32)
    words = rng.integers(-2**31, 2**31, (S, OR_ITEMS, OR_WORDS),
                         dtype=np.int64).astype(np.int32)
    return gidx, words


PRIM_N, PRIM_ITEMS = 128, 16


def prim_input(S: int):
    """The routed primitives' inputs: a global table, and per rank the ids
    to fetch, the ids and values to add."""
    rng = np.random.default_rng(2)
    return (rng.standard_normal(PRIM_N).astype(np.float32),
            rng.integers(0, PRIM_N, (S, PRIM_ITEMS)).astype(np.int32),
            rng.integers(0, PRIM_N, (S, PRIM_ITEMS)).astype(np.int32),
            rng.standard_normal((S, PRIM_ITEMS)).astype(np.float32))


def _stats(s, cap: int, m: int, m_rev: int = 0):
    """A run's stats as plain data, with what its levels routed at: the
    compacted push capacity, the full one and the pull's."""
    out = {k: s[k] for k in ("iters", "pushes", "pulls", "fallbacks",
                             "levels")}
    out["trace"] = s["trace"].cpu().numpy()
    out.update(cap=cap, m=m, m_rev=m_rev)
    return out


def run_cases(mesh) -> dict:
    """Every case on this rank; rank 0 returns the gathered results."""
    S, dev, rank = mesh.size, mesh.device, mesh.rank
    g, gsym, gq = graphs()
    n = g.n_rows
    out, stats = {}, {}

    def keep(name, x):
        y = mesh.gather(x)
        if y is not None:
            out[name] = y.cpu().numpy()

    # spmv: degree-balanced rows, block-partitioned x
    gsh, row_att = shard_graph(g, S)
    x_att = dgas.block_rule(n, S)
    x = torch.from_numpy(spmv_input(n))
    x_local = A.shard_vertex_array(x, x_att)[rank].to(dev)
    for mode in ("dgas", "allgather"):
        keep(f"spmv/{mode}", A.spmv_distributed(gsh, x_local, x_att,
                                                row_att, mesh, mode=mode))
    # a rule with padding slots (the reference leaks mass into them)
    keep("pagerank/balanced", A.pagerank_distributed(gsh, row_att, mesh,
                                                     iters=15))

    att2 = dgas.block_rule(n, S)
    gsh2, _ = shard_graph(g, S, row_att=att2)
    local = gsh2.shard(rank, dev)
    keep("pagerank", A.pagerank_distributed(local, att2, mesh, iters=15))
    keep("bfs/push", A.bfs_distributed(local, att2, 0, mesh))
    g_rev = engine.reverse_graph(g, att2)
    lv, st = A.bfs_distributed(local, att2, 0, mesh, g_rev=g_rev,
                               mode="auto", return_stats=True)
    keep("bfs/auto", lv)
    keep("sssp", A.sssp_distributed(local, att2, 0, mesh, delta=0.5))
    for k in ASYNC_K:
        keep(f"bfs/async{k}", A.bfs_distributed(
            local, att2, 0, mesh, placement="async", sync_interval=k))
        keep(f"sssp/async{k}", A.sssp_distributed(
            local, att2, 0, mesh, delta=0.5, placement="async",
            sync_interval=k))
    atts = dgas.block_rule(gsym.n_rows, S)
    gshs, _ = shard_graph(gsym, S, row_att=atts)
    keep("cc", A.connected_components_distributed(gshs, atts, mesh))
    gsh_t, _ = shard_graph(g.transpose(), S, row_att=att2)
    keep("lpa", A.label_propagation_distributed(gsh_t.shard(rank, dev), att2,
                                                mesh, iters=5))

    # the engine directly: the compacted push at three capacities, and
    # the runs held to the reference's distributed stats
    level0 = torch.full((att2.per_shard,), -1, dtype=torch.int32, device=dev)
    f0 = torch.zeros(att2.per_shard, dtype=torch.int32, device=dev)
    _, src_local = source_rows(att2, [0], mesh)
    level0[src_local], f0[src_local] = 0, 1
    m, m_rev = gsh2.edges_per_shard, g_rev.edges_per_shard
    tuned = engine.frontier_edge_capacity(
        m, engine._tune.resolve("engine.switch_frac", None, n=n, device=dev),
        n=n, device=dev)
    caps = {"tiny": CAP_TINY, "derived": engine.frontier_edge_capacity(
        m, 1 / 32, n=n, device=dev), "disabled": 0}
    for name, cap in caps.items():
        st_, s_ = engine.run_distributed(
            local, att2, mesh, A.bfs_program(), {"level": level0.clone()},
            f0.clone(), max_iters=64, mode="push", push_edge_capacity=cap,
            return_stats=True, trace=True)
        keep(f"bfs/cap_{name}", st_["level"])
        stats[f"bfs/cap_{name}"] = _stats(s_, cap, m)
    _, s_ = engine.run_distributed(
        local, att2, mesh, A.bfs_program(), {"level": level0.clone()},
        f0.clone(), max_iters=64, g_rev=g_rev, mode="auto",
        return_stats=True, trace=True)
    stats["bfs/auto"] = _stats(s_, tuned, m, m_rev)
    dist0 = torch.where(f0 > 0, 0.0, float("inf"))
    _, s_ = engine.run_distributed(
        local, att2, mesh, A.bfs_level_program(), {"dist": dist0}, f0.clone(),
        max_iters=64 * 2, mode="push", placement="async", sync_interval=2,
        return_stats=True, trace=True)
    stats["bfs/async2"] = _stats(s_, 0, att2.per_shard)
    state0 = {"dist": dist0.clone(), "pending": f0 > 0,
              "bound": torch.tensor(0.5, device=dev)}
    prog = A.sssp_program(0.5, global_min=lambda v: offload.global_min(
        v, mesh))
    _, s_ = engine.run_distributed(local, att2, mesh, prog, state0,
                                   f0.clone(), max_iters=256, mode="push",
                                   return_stats=True, trace=True)
    stats["sssp"] = _stats(s_, tuned, m)

    # batched lanes on rmat(7, 8, seed=3), block rule
    att_q = dgas.block_rule(gq.n_rows, S)
    gsh_q, _ = shard_graph(gq, S, row_att=att_q)
    m_q = gsh_q.edges_per_shard
    cap_q = engine.frontier_edge_capacity(
        m_q, engine._tune.resolve("engine.switch_frac", None, n=gq.n_rows,
                                  device=dev), n=gq.n_rows, device=dev)
    lv_b, s_ = A.msbfs_distributed(gsh_q, att_q, SOURCES, mesh,
                                   return_stats=True, trace=True)
    keep("msbfs", lv_b)
    stats["msbfs"] = _stats(s_, cap_q, m_q)
    keep("msbfs/async2", A.msbfs_distributed(gsh_q, att_q, SOURCES, mesh,
                                             placement="async",
                                             sync_interval=2))
    d_b, s_ = A.sssp_batched_distributed(gsh_q, att_q, SOURCES, mesh,
                                         delta=1.0, return_stats=True,
                                         trace=True)
    keep("sssp_batched", d_b)
    stats["sssp_batched"] = _stats(s_, cap_q, m_q)

    # the routed primitives at S ranks, under both closed-form rules
    table, gidx, aidx, avals = prim_input(S)
    for kind in ("interleave", "block"):
        att = getattr(dgas, f"{kind}_rule")(PRIM_N, S)
        mine = A.shard_vertex_array(table, att)[rank].to(dev)
        g_ = torch.from_numpy(gidx[rank]).to(dev)
        keep(f"dgas_gather/{kind}", offload.dgas_gather(
            mine, g_, att, mesh, capacity=PRIM_ITEMS))
        keep(f"all_gather_gather/{kind}", offload.all_gather_gather(
            mine, g_, att, mesh))
        keep(f"scatter_add/{kind}", offload.remote_scatter_add(
            torch.zeros(att.per_shard, device=dev),
            torch.from_numpy(aidx[rank]).to(dev),
            torch.from_numpy(avals[rank]).to(dev), att, mesh,
            capacity=PRIM_ITEMS * S))
    keep("prefix_scan", offload.prefix_scan(
        torch.tensor([rank + 3], device=dev), mesh))
    # packed lanes under the async placement: the seen words' fixpoint
    # (a union) does not depend on the schedule
    B = len(SOURCES)
    lanes, src_l = source_rows(att_q, SOURCES, mesh)
    bits = torch.zeros((B, att_q.per_shard), dtype=torch.int32, device=dev)
    bits[lanes, src_l] = 1
    words0 = engine.pack_lanes(bits)
    level0 = torch.full((B, att_q.per_shard), -1, dtype=torch.int32,
                        device=dev)
    for placement, k in (("sync", 1), ("async", 2)):
        st_ = engine.run_batched_distributed(
            gsh_q, att_q, mesh, A.msbfs_program(B),
            {"seen": words0.clone(), "level": level0.clone()},
            words0.clone(), max_iters=64, placement=placement,
            sync_interval=k)
        keep(f"seen/{placement}", st_["seen"])

    # remote_scatter_or under an interleave rule
    att_or = dgas.interleave_rule(OR_N, S)
    gidx, words = or_input(S)
    keep("scatter_or", offload.remote_scatter_or(
        att_or.per_shard, torch.from_numpy(gidx[rank]).to(dev),
        torch.from_numpy(words[rank]).to(dev), att_or, mesh,
        capacity=OR_ITEMS * S))
    out["backend"] = mesh.backend
    return {"arrays": out, "stats": stats} if rank == 0 else None


CARD_SCALE = 16
CARD_SOURCES = np.arange(32, dtype=np.int32) * 97


def run_card_case(mesh) -> dict:
    """``bfs_distributed`` (auto, with the reverse shards) and
    ``msbfs_distributed`` at RMAT-16 under the degree-balanced rule, the
    shards on this rank's card; rank 0 returns the global levels."""
    g = rmat(CARD_SCALE, 16, seed=7, device=mesh.device)
    gsh, att = shard_graph(g, mesh.size)
    g_rev = engine.reverse_graph(g, att)
    lv = A.bfs_distributed(gsh, att, 0, mesh, g_rev=g_rev, mode="auto")
    lv_b = A.msbfs_distributed(gsh, att, CARD_SOURCES, mesh)
    lv, lv_b = mesh.gather(lv), mesh.gather(lv_b)
    if mesh.rank:
        return None
    return {"device": str(lv.device), "backend": mesh.backend,
            "bfs": A.unshard_vertex_array(lv, att).numpy(),
            "msbfs": np.stack([A.unshard_vertex_array(lv_b[:, b], att).numpy()
                               for b in range(len(CARD_SOURCES))])}


def rank_or_fail(mesh, bad: int) -> int:
    """Rank ``bad`` raises; the others wait in a collective that never
    completes (``bad`` < 0: every rank returns its rank)."""
    if mesh.rank == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    if bad < 0:
        mesh.barrier()
    else:
        mesh.all_reduce(torch.ones(1), "sum")
    return mesh.rank
