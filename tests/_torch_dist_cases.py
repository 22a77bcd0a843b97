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
from repro_torch.core.graph import GraphHandle, rmat

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


def wait_in_sleep(seconds: float) -> None:
    """A frame of its own to block in, for a stack dump to name."""
    import time
    time.sleep(seconds)


def block_past_timeout(mesh, seconds: float) -> int:
    """Rank 0 sleeps ``seconds`` in :func:`wait_in_sleep`; the others wait
    for it in a barrier."""
    if mesh.rank == 0:
        wait_in_sleep(seconds)
    mesh.barrier()
    return mesh.rank


def skip_a_collective(mesh, kind: str, seconds: float) -> int:
    """Rank 1 skips the collective ``kind`` ('all_reduce' or 'barrier')
    that rank 0 makes and waits in :func:`wait_in_sleep` instead; rank 0's
    collective outlives the group's timeout."""
    if mesh.rank == 1:
        wait_in_sleep(seconds)
    elif kind == "barrier":
        mesh.barrier()
    else:
        mesh.all_reduce(torch.ones(1), "sum")
    return mesh.rank


def restore_while_rank0_saves(mesh, work: str, delay: float) -> dict:
    """A ``CheckpointManager`` over a fresh directory on every rank: rank
    1 reads its directory ``delay`` seconds late, while rank 0, once its
    ``restore_latest`` has returned nothing, writes step 0 at once (as
    ``run_training`` does).  Returns what this rank restored and its
    collectives' count after the save's wait."""
    import time
    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed.sharding import Placement
    if mesh.rank == 1:
        real = ckpt.latest_step

        def late(directory):
            time.sleep(delay)
            return real(directory)
        ckpt.latest_step = late
    tree = {"w": torch.arange(4.0)}
    shard = {"w": Placement((None,), mesh)}
    cm = ckpt.CheckpointManager(work, every=1)
    restored, step = cm.restore_latest(tree, shardings=shard)
    if restored is None:
        cm.maybe_save(0, tree, force=True, shardings=shard)
    cm.wait()
    return {"step": step, "collectives": mesh.collectives}


def sigterm_on_one_rank(mesh, work: str, at: int) -> dict:
    """``run_training`` with ``install_sigterm`` over a state split across
    the mesh (checkpoints every 100 steps, so only step 0 and the SIGTERM
    save write); each step all-reduces, as a meshed step does.  Rank 1
    alone sends itself SIGTERM once the step to ``at`` is done.  Returns
    this rank's exit code and the checkpoint steps on disk."""
    import os
    import signal
    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed import fault_tolerance as FT
    from repro_torch.distributed.sharding import Placement
    from repro_torch.optim.adamw import TrainState
    pl = {"w": Placement((mesh.axis_names[0],), mesh)}
    block = lambda: torch.zeros(2)
    state = TrainState({"w": block()}, {"w": block()}, {"w": block()},
                       torch.zeros((), dtype=torch.int32))

    def step_fn(st, batch):
        g = mesh.all_reduce(torch.ones(2), "sum")
        return (TrainState({"w": st.params["w"] + g}, st.m, st.v,
                           st.step + 1), {"loss": g.sum()})

    def on_metrics(step, metrics):
        if step == at and mesh.rank == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    def batches():
        while True:
            yield None
    try:
        FT.run_training(step_fn, state, batches(),
                        ckpt.CheckpointManager(work, every=100), 10,
                        FT.FTConfig(ckpt_every=100, install_sigterm=True),
                        on_metrics=on_metrics,
                        shardings=TrainState(pl, pl, pl, None))
        code = 0
    except SystemExit as e:
        code = e.code
    return {"code": code, "steps": sorted(
        int(d.split("_")[1]) for d in os.listdir(work)
        if d.startswith("step_"))}


# ---------------------------------------------------------------------------
# The second half of the distributed placement (tests/test_torch_dist_more.py)
# ---------------------------------------------------------------------------

GRID = ((2, 2), ("data", "model"))
QUEUE_CAP, QUEUE_COUNTS = 16, (5, 0, 16, 9)
WALK_STEPS, WALK_KEY, WALK_K = 12, 41, (1, 3)
SVC_BUDGET, SVC_K = 4, 2
DEADLINE_QUERIES = 6
UPDATE_SMALL = (np.array([40, 70, 97]), np.array([120, 5, 64]))   # shards 1-3


def queue_input(S: int):
    """Per rank a queue holding QUEUE_COUNTS[r] items and a (cap, 2) f32
    payload (-0.0 in some rows: routed as +0.0, as the reference adds)."""
    rng = np.random.default_rng(4)
    items = np.full((S, QUEUE_CAP), -1, np.int32)
    pay = np.zeros((S, QUEUE_CAP, 2), np.float32)
    for s, c in enumerate(QUEUE_COUNTS[:S]):
        items[s, :c] = rng.integers(0, 1000, c)
        pay[s, :c] = rng.standard_normal((c, 2))
    pay[0, 1, 0] = -0.0
    return items, np.array(QUEUE_COUNTS[:S], np.int32), pay


def louvain_graph(integer: bool):
    """rmat(7, 8, seed=3) as numpy CSR arrays, its f32 weights or integer
    weights 1..8 (exact in f32 whatever the order of the sums)."""
    g = rmat(7, 8, seed=3, device="cpu")
    v = g.values.numpy()
    if integer:
        v = np.floor(v * 8).astype(np.float32) + 1
    return g.indptr.numpy(), g.indices.numpy(), v, g.n_rows


def louvain_labels(n: int) -> np.ndarray:
    """A labeling with a few large communities and label ids up to n."""
    rng = np.random.default_rng(6)
    return rng.choice(np.arange(0, n, 7), n).astype(np.int32)


def update_big(n: int, S: int):
    """Inserts that overflow the padding of the block rule's shard 1."""
    per = -(-n // S)
    rng = np.random.default_rng(8)
    rows = rng.integers(per, 2 * per, 400)
    return rows, rng.integers(0, n, 400)


def service_stream(n: int):
    """Reachability and Distance queries over SVC_BUDGET + 2 sources (so
    the traversal kinds batch more than once), then repeats (cache hits)."""
    rng = np.random.default_rng(9)
    out = []
    for i in range(16):
        s, t = int(rng.integers(0, SVC_BUDGET + 2)), int(rng.integers(0, n))
        out.append(("reach" if i % 2 else "dist", s, t))
    return out + out[:3]


def walks_on_run_queue(ip, ix, v_att, e_att, w, n: int, k: int):
    """The walks of every vertex on ``run_queue`` driven directly, with
    ``walk_queue_program`` balancing every ``k``-th step: walker i starts
    on rank i % S.  Rank 0 returns the (n, WALK_STEPS + 1) paths."""
    from repro_torch.core.algorithms.random_walks import walk_queue_program
    S = w.size
    cap = -(-n // S)
    mine = torch.arange(w.rank, n, S, dtype=torch.int32)
    items0 = torch.full((cap,), -1, dtype=torch.int32)
    items0[:mine.numel()] = mine
    _, (ids, vs) = engine.run_queue(
        w, walk_queue_program(v_att, e_att, w, cap), items0,
        items0.clamp(min=0), (ip, ix), n_iters=WALK_STEPS, key=WALK_KEY,
        sync_interval=k)
    ids, vs = w.gather(ids), w.gather(vs)
    if ids is None:
        return None
    walks = torch.empty((n, WALK_STEPS + 1), dtype=torch.int32)
    walks[:, 0] = torch.arange(n)
    step = torch.arange(1, WALK_STEPS + 1).reshape(1, -1, 1).expand_as(ids)
    sel = ids >= 0
    walks[ids[sel].long(), step[sel]] = vs[sel]
    return walks


def run_deadline_service(svc, n: int, mod) -> dict:
    """The stream's first DEADLINE_QUERIES queries, each submitted with a
    zero deadline (so each submit is a flush opportunity that flushes),
    then one explicit flush: answers and the admission collectives."""
    kinds = {"reach": mod.Reachability, "dist": mod.Distance}
    ts = [svc.submit(kinds[k](s, t), deadline=0.0)
          for k, s, t in service_stream(n)[:DEADLINE_QUERIES]]
    svc.flush()
    return {"answers": np.array([float(svc.result(t)) for t in ts]),
            "batches": int(svc.stats.batches),
            "admissions": int(svc.admission["collectives"])}


def _csr(indptr, indices, vals, n):
    from repro_torch.core.graph import csr_from_numpy
    return csr_from_numpy(indptr, indices, vals, n, n, device="cpu")


def run_service(svc, n: int, mod) -> dict:
    """The stream, an insert batch, the stream again: answers and the
    route-byte ledger (``mod`` the service module of either package)."""
    kinds = {"reach": mod.Reachability, "dist": mod.Distance}

    def one():
        ts = [svc.submit(kinds[k](s, t)) for k, s, t in service_stream(n)]
        svc.flush()
        return [float(svc.result(t)) for t in ts]

    first = one()
    svc.apply_updates(UPDATE_SMALL)
    return {"answers": np.array(first + one()),
            "route_bytes": int(svc.stats.route_bytes),
            "batches": int(svc.stats.batches),
            "hits": int(svc.stats.cache_hits)}


def run_more_cases(mesh) -> dict:
    """Every case of the second half on this rank of the (2, 2) grid; the
    1-D mesh of 4 is its flattened world.  Rank 0 returns the results."""
    from repro_torch.core import service as TS
    from repro_torch.core.algorithms import louvain as TL
    from repro_torch.core.algorithms.random_walks import (
        random_walks_distributed, walk_shards)
    from repro_torch.core.traffic import RouteByteCounter
    from repro_torch.obs import get_registry
    w = mesh.over(("data", "model"))
    S, dev, rank = w.size, w.device, w.rank
    out = {}

    def keep(name, x):
        y = w.gather(x)
        if y is not None:
            out[name] = y.cpu().numpy()

    # queue engine: queue_balance on the reference's inputs
    items, counts, pay = queue_input(S)
    q = offload.QueueState(torch.from_numpy(items[rank]),
                           torch.tensor(counts[rank]))
    qb, pb = offload.queue_balance(q, w, torch.from_numpy(pay[rank]))
    keep("queue/items", qb.items)
    keep("queue/count", qb.count.reshape(1))
    keep("queue/payload", pb)
    # walks on the queue engine, one walker per vertex
    gq = rmat(7, 8, seed=3, device="cpu")
    ip, ix, v_att, e_att = walk_shards(gq.indptr, gq.indices, S, rank)
    for k in WALK_K:
        # cadence 1 is the entry point's; the others drive run_queue
        walks = random_walks_distributed(
            ip, ix, v_att, e_att, np.arange(gq.n_rows), WALK_STEPS,
            WALK_KEY, mesh, axis=("data", "model")) if k == 1 else \
            walks_on_run_queue(ip, ix, v_att, e_att, w, gq.n_rows, k)
        if rank == 0:
            out[f"walks/k{k}"] = walks.numpy()

    # Louvain: modularity and contraction on a labeling, multilevel
    for integer in (True, False):
        tag = "int" if integer else "f32"
        csr = _csr(*louvain_graph(integer))
        att = dgas.block_rule(csr.n_rows, S)
        mine = shard_graph(csr, S, row_att=att)[0].shard(rank, dev)
        lab = A.shard_vertex_array(louvain_labels(csr.n_rows), att)[rank]
        keep(f"louvain/{tag}/q", TL.modularity_distributed(
            mine, att, w, lab).reshape(1))
        ctr = RouteByteCounter(S)
        coarse, catt, ren, n_routed = TL.contract_distributed(
            mine, att, lab, w, counter=ctr)
        for f in ("src", "dst", "val"):
            keep(f"louvain/{tag}/coarse_{f}", getattr(coarse, f))
        out[f"louvain/{tag}/renumber"] = ren.numpy()
        out[f"louvain/{tag}/routed"] = np.array([n_routed, ctr.total_bytes])
        labels, scores = TL.multilevel_distributed(mine, att, mesh,
                                                   axis=("data", "model"))
        out[f"louvain/{tag}/ml"] = labels.numpy()
        out[f"louvain/{tag}/ml_scores"] = np.array(scores)

    # streaming on shards: update_shards, then both repairs
    g = rmat(7, 8, seed=3, device="cpu")
    n = g.n_rows
    att = dgas.block_rule(n, S)
    gsh, _ = shard_graph(g, S, row_att=att)
    mine = gsh.shard(rank, dev)
    h0 = GraphHandle.wrap(g, n_partitions=S)
    ctr = get_registry().counter("streaming.reshard_fallback")
    c0 = ctr.value
    h_big, rep_big = h0.apply(update_big(n, S))
    shards = np.unique(att.owner(torch.as_tensor(
        rep_big.changed_sources)).numpy())
    out["update/big_none"] = np.array([A.update_shards(
        mine, h_big.csr, att, shards, w) is None])
    h1, rep = h0.apply(UPDATE_SMALL)
    shards = np.unique(att.owner(torch.as_tensor(
        rep.changed_sources)).numpy())
    new = A.update_shards(mine, h1.csr, att, shards, w)
    out["update/fallbacks"] = np.array([ctr.value - c0])
    for f in ("src", "dst", "val"):
        keep(f"update/{f}", getattr(new, f))
    out["update/same_object"] = np.array([new is mine])
    lv0 = A.bfs_distributed(mine, att, 0, w)
    keep("repair/bfs", A.bfs_repair_distributed(
        new, att, lv0, rep.changed_sources, w))
    keep("repair/bfs_async", A.bfs_repair_distributed(
        new, att, lv0, rep.changed_sources, w, placement="async",
        sync_interval=2))
    keep("fresh/bfs", A.bfs_distributed(new, att, 0, w))
    sym0, sym1 = A.symmetrize(g), A.symmetrize(h1.csr)
    atts = dgas.block_rule(n, S)
    s0 = shard_graph(sym0, S, row_att=atts)[0].shard(rank, dev)
    s1 = shard_graph(sym1, S, row_att=atts)[0].shard(rank, dev)
    cc0 = A.connected_components_distributed(s0, atts, w)
    keep("repair/cc", A.cc_repair_distributed(
        s1, atts, cc0, rep.changed_vertices, w))
    keep("fresh/cc", A.connected_components_distributed(s1, atts, w))

    # the service on the mesh, sync and async
    for placement in ("sync", "async"):
        svc = TS.GraphService(g, batch_budget=SVC_BUDGET, mesh=mesh,
                              placement=placement, sync_interval=SVC_K)
        res = run_service(svc, n, TS)
        if rank == 0:
            out.update({f"service/{placement}/{k}": np.asarray(v)
                        for k, v in res.items()})
    res = run_deadline_service(TS.GraphService(
        g, batch_budget=SVC_BUDGET, mesh=mesh), n, TS)
    if rank == 0:
        out.update({f"service/deadline/{k}": np.asarray(v)
                    for k, v in res.items()})
    # calls that diverge (one rank submits more) fail on every rank
    svc = TS.GraphService(g, batch_budget=SVC_BUDGET, mesh=mesh)
    if rank == 0:
        svc.submit(TS.Reachability(0, 1))
    try:
        svc.flush()
        raised = False
    except RuntimeError:
        raised = True
    keep("service/diverged_raises", torch.tensor([int(raised)]))

    # the (2, 2) grid: tuple axes, sub-axis groups, hierarchical psum
    keep("grid/bfs", A.bfs_distributed(mine, att, 0, mesh,
                                       axis=("data", "model")))
    keep("grid/sssp", A.sssp_distributed(mine, att, 0, mesh, delta=0.5,
                                         axis=["data", "model"]))
    x = torch.tensor([float(rank + 1), 10.0 * (rank + 1)], device=dev)
    keep("grid/hpsum", offload.hierarchical_psum(x, ("data", "model"), mesh))
    keep("grid/hpsum_meshes", offload.hierarchical_psum(
        x, [mesh.over("model"), mesh.over("data")]))
    keep("grid/psum_1d", w.all_reduce(x))
    keep("grid/data", mesh.over("data").all_reduce(x))
    keep("grid/model", mesh.over("model").all_reduce(x))
    return out if rank == 0 else None


def run_card_service(mesh, placement: str) -> dict:
    """``GraphService(mesh=...)`` on this rank's card at RMAT-12: the
    service stream, an insert batch, the stream again; rank 0 returns the
    answers and where the shard lived."""
    from repro_torch.core import service as TS
    g = rmat(12, 16, seed=7, device=mesh.device)
    svc = TS.GraphService(g, batch_budget=SVC_BUDGET, mesh=mesh,
                          placement=placement, sync_interval=SVC_K)
    res = run_service(svc, g.n_rows, TS)
    res["device"] = str(svc._shard.src.device)
    return res if mesh.rank == 0 else None
