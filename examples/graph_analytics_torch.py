"""The paper's Table II workloads end-to-end on one RMAT graph, on the torch
port.  Runs on the card unless given ``--device cpu``; on the card SpMV,
SpMSpV, BFS and SSSP also take their BBCSR kernels (B1, B2, B3).

  PYTHONPATH=src python examples/graph_analytics_torch.py [--scale 12]
      [--device cpu] [--ranks N] [--placement sync|async] [--stream N]
      [--trace out.json]

``--ranks N`` (N >= 2) runs the distributed serving demo on N ranks
(``torch.distributed``, gloo; on the card the ranks share it): the graph
query service over a process mesh, every query carrying a deadline, with
its latency p50 / p95 and deadline-miss rate.  ``--placement async`` adds
a sync-vs-async traversal comparison on the sharded graph (bounded-
staleness shard pacing, ``--sync-interval`` micro-steps per global check).

``--stream N`` ingests N edge-update batches through
``GraphService.apply_updates`` while the service keeps answering, printing
per-epoch repair-vs-scratch latency and the partition-scoped cache
survival.

``--trace out.json`` attaches a telemetry bundle to the served stream (the
deadline mix when the distributed demo runs, the local mixed stream
otherwise), writes the Chrome ``trace_event`` JSON and prints the
per-phase summary table.

``main(argv)`` returns the numbers it prints.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import engine, rmat, to_bbcsr
from repro_torch.core.algorithms import (bfs, connected_components,
                                         label_propagation, modularity,
                                         multilevel, pagerank, random_walks,
                                         spmspv, spmv, spmv_bbcsr, sssp,
                                         sssp_batched, symmetrize,
                                         ties_sample)
from repro_torch.core.service import (Distance, GraphService, NeighborSample,
                                      PPRTopK, Reachability)
from repro_torch.kernels import ops


def _timed(name: str, fn, dev: torch.device):
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"  {name:28s} {1e3 * (time.perf_counter() - t0):8.1f} ms")
    return out


def _observability():
    from repro_torch.obs import MetricsRegistry, Observability
    return Observability(metrics=MetricsRegistry())


def _export(obs, path: str) -> int:
    from repro_torch.obs import format_summary
    doc = obs.export_chrome_trace(path)
    print(f"\n  trace: wrote {path} ({len(doc['traceEvents'])} events;"
          " load at chrome://tracing or ui.perfetto.dev)")
    for line in format_summary(obs.summary()).splitlines():
        print("  " + line)
    return len(doc["traceEvents"])


def distributed_demo(mesh, scale: int, placement: str, sync_interval: int,
                     trace: Optional[str]) -> Optional[dict]:
    """One rank of the distributed serving demo (every rank makes the same
    calls; rank 0 prints and returns the numbers)."""
    dev = mesh.device
    g = rmat(scale, 16, seed=7, device=dev)
    rng = np.random.default_rng(3)
    lead = mesh.rank == 0
    out = {}

    def timed(name, fn):
        mesh.barrier()
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        if lead:
            print(f"  {name:28s} {ms:8.1f} ms")
        return ms

    if placement == "async":
        # head-to-head traversal latency: the same sharded graph, sync
        # level barrier vs bounded-staleness pacing (warm runs)
        from repro_torch.core import dgas
        from repro_torch.core.algorithms import sssp_batched_distributed
        from repro_torch.core.algorithms.distgraph import shard_graph
        gsh, att = shard_graph(g, mesh.size,
                               row_att=dgas.block_rule(g.n_rows, mesh.size))
        srcs = rng.integers(0, g.n_rows, 8).astype(np.int32)
        for pl in ("sync", "async"):
            def fn(pl=pl):
                return sssp_batched_distributed(
                    gsh, att, srcs, mesh, placement=pl,
                    sync_interval=sync_interval)
            fn()
            out[f"sssp_x8_{pl}_ms"] = timed(
                f"SSSP x8 on {mesh.size} shards ({pl})", fn)

    obs = _observability() if trace else None
    svc = GraphService(g, batch_budget=32, mesh=mesh, cache_capacity=1024,
                       placement=placement, sync_interval=sync_interval,
                       cost_seed="auto", obs=obs)
    for warm in (Reachability(0, 1), PPRTopK(0, k=4)):
        svc.query(warm)
    svc.reset_stats()
    if obs is not None:
        obs.clear()            # trace the deadline mix, not the warm-up
    for i in range(64):        # a deadline mix: reachability + PPR top-k
        s = int(rng.integers(0, g.n_rows))
        q = (Reachability(s, int(rng.integers(0, g.n_rows)))
             if i % 2 == 0 else PPRTopK(s, k=4))
        svc.submit(q, deadline=30.0)
        svc.poll()             # the client-driven admission tick
    out["service_ms"] = timed("Distributed service (64 q)", svc.flush)
    st = svc.stats
    if not lead:
        return None
    print(f"  distributed stats      {st}")
    print(f"  latency p50/p95        {st.latency_p50_ms:.1f} / "
          f"{st.latency_p95_ms:.1f} ms")
    print(f"  deadline miss rate     {st.deadline_miss_rate:.3f} "
          f"({st.deadline_misses}/{st.deadline_queries})")
    out.update(queries=st.queries, latency_p50_ms=st.latency_p50_ms,
               latency_p95_ms=st.latency_p95_ms,
               deadline_miss_rate=st.deadline_miss_rate,
               collectives=mesh.collectives)
    if obs is not None:
        out["trace_events"] = _export(obs, trace)
    return out


def _stream(g, n_batches: int, dev: torch.device) -> dict:
    """The streaming demo: update batches while the service serves."""
    from repro_torch.core import GraphHandle
    from repro_torch.core.algorithms import (auto_delta, bfs_repair,
                                             sssp_repair)
    k = max(1, g.nnz // 200)          # 0.5% of edges per batch
    print(f"\n  streaming: {n_batches} update batches ({k} edges each) "
          f"while serving")
    ssvc = GraphService(g, batch_budget=32, cache_capacity=1024)
    per = ssvc.handle.per_partition
    probe = [NeighborSample((p * per + 3) % g.n_rows, fanout=2)
             for p in range(8)]
    for q in probe:
        ssvc.query(q)                 # one cached entry per partition
    handle = GraphHandle.wrap(g, n_partitions=8)
    prev_lv = bfs(handle.csr, 0)
    prev_d = sssp(handle.csr, 0, delta=auto_delta(handle.csr))
    srng = np.random.default_rng(11)

    def new_edges(csr):
        # genuinely new edges (rejection-sampled, weights at the graph's own
        # U[0,1) scale): pure growth, so every batch is monotone-safe
        indptr = csr.indptr.cpu().numpy()
        have = np.repeat(np.arange(csr.n_rows, dtype=np.int64),
                         np.diff(indptr)) * csr.n_cols \
            + csr.indices.cpu().numpy().astype(np.int64)
        keys = np.empty(0, np.int64)
        while keys.size < k:
            cand = (srng.integers(0, csr.n_rows, 2 * k) * csr.n_cols
                    + srng.integers(0, csr.n_cols, 2 * k))
            keys = np.unique(np.concatenate([keys,
                                             cand[~np.isin(cand, have)]]))
        keys = srng.permutation(keys)[:k]
        return keys // csr.n_cols, keys % csr.n_cols, \
            srng.random(k).astype(np.float32)

    def wall(fn):
        t0 = time.perf_counter()
        r = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return r, 1e3 * (time.perf_counter() - t0)

    epochs = []
    for epoch in range(1, n_batches + 1):
        ins = new_edges(handle.csr)
        cached_before = len(ssvc._cache)
        rep = ssvc.apply_updates(inserts=ins)
        handle, hrep = handle.apply(ins)
        csr, ch = handle.csr, hrep.changed_sources
        delta = auto_delta(csr)
        _, scratch_ms = wall(lambda: sssp(csr, 0, delta=delta))
        prev_d, repair_ms = wall(lambda: sssp_repair(csr, prev_d, ch))
        prev_lv = bfs_repair(csr, prev_lv, ch)
        ssvc.query(probe[7])          # the stream keeps serving mid-ingest
        live = len(ssvc._cache)
        print(f"  epoch {epoch:3d}: sssp scratch {scratch_ms:8.1f} ms  "
              f"repair {repair_ms:8.1f} ms "
              f"({scratch_ms / max(repair_ms, 1e-9):5.1f}x)  cache "
              f"{live}/{cached_before} live  "
              f"touched={rep.touched_partitions.tolist()}")
        epochs.append({"scratch_ms": scratch_ms, "repair_ms": repair_ms,
                       "cache_live": live})
    reached = int(torch.isfinite(prev_d).sum())
    print(f"  final epoch            {ssvc.epoch} (service) / "
          f"{handle.epoch} (handle)")
    print(f"  sssp reached (stream)  {reached}/{g.n_rows}")
    return {"epochs": epochs, "sssp_reached": reached,
            "bfs_reached": int((prev_lv >= 0).sum())}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks of the distributed serving demo (runs at "
                         "2 or more)")
    ap.add_argument("--placement", choices=("sync", "async"), default="sync",
                    help="distributed demo placement; async = bounded-"
                         "staleness shard pacing")
    ap.add_argument("--sync-interval", type=int, default=8,
                    help="micro-steps per global check when --placement "
                         "async")
    ap.add_argument("--stream", type=int, default=0, metavar="N",
                    help="streaming demo: ingest N update batches")
    ap.add_argument("--trace", metavar="PATH",
                    help="record the served stream and write a Chrome "
                         "trace_event JSON")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    g = rmat(args.scale, 16, seed=7, device=dev)
    print(f"RMAT-{args.scale}: {g.n_rows} vertices, {g.nnz} edges")
    x = torch.as_tensor(np.random.default_rng(0).random(g.n_cols, np.float32),
                        device=dev)

    def timed(name, fn):
        return _timed(name, fn, dev)

    timed("SpMV", lambda: spmv(g, x))
    bb = engine.build_pull_operand(g)          # A^T: one pull step
    timed("SpMV (B1 kernel)", lambda: spmv_bbcsr(to_bbcsr(g), x))
    act = torch.arange(32, dtype=torch.int32, device=dev)
    ys = timed("SpMSpV (32 active)", lambda: spmspv(
        g, act, torch.ones(32, device=dev), max_deg=256))
    frontier = torch.zeros(g.n_rows, dtype=torch.int32, device=dev)
    frontier[:32] = 1
    xs = torch.where(frontier.bool(), 1.0, 0.0)
    ys_k = timed("SpMSpV (B2 kernel)", lambda: ops.spmspv_dma(
        bb, xs, engine.tile_active(bb, frontier), combine="add"))
    pr = timed("PageRank (20 it)", lambda: pagerank(g, iters=20))
    bb_u = engine.build_pull_operand(g, unit_values=True)
    lv = timed("BFS (B1 / B2 kernels)", lambda: bfs(g, 0, max_levels=48,
                                                     kernel_bb=bb_u))
    timed("Random walks (4096x16)", lambda: random_walks(
        g, torch.arange(4096, device=dev) % g.n_rows, 16, 0))
    lab = timed("Louvain (LPA, 8 it)", lambda: label_propagation(g, iters=8))
    mlab, mscores = timed("Louvain (multi-level)", lambda: multilevel(g))
    bb_m = engine.build_pull_operand(g, combine="min")
    dist = timed("SSSP (B3 kernel)", lambda: sssp_batched(
        g, [0], kernel_bb=bb_m)[0])
    gsym = symmetrize(g)
    comp = timed("Connected components", lambda: connected_components(
        gsym, symmetrize_input=False))
    nodes, n_nodes, mask = timed("TIES sampler", lambda: ties_sample(
        g, 512, 1024, 0))
    del bb, bb_u, bb_m

    # the graph query service: micro-batched multi-source serving
    use_dist = args.ranks >= 2
    obs = _observability() if args.trace and not use_dist else None
    svc = GraphService(g, batch_budget=32, cache_capacity=1024, obs=obs)
    for warm in (Reachability(0, 1), Distance(0, 1), PPRTopK(0, k=4),
                 NeighborSample(0, fanout=2)):
        svc.query(warm)
    svc.reset_stats()
    if obs is not None:
        obs.clear()          # the trace shows serving, not the warm-up
    rng = np.random.default_rng(3)
    stream = []
    for i in range(96):      # a mixed query stream, as a client submits it
        s, t = int(rng.integers(0, g.n_rows)), int(rng.integers(0, g.n_rows))
        stream.append([Reachability(s, t), Distance(s, t), PPRTopK(s, k=4),
                       NeighborSample(s, fanout=2)][i % 4])
    tickets = [svc.submit(q) for q in stream]
    timed("Query service (96 q)", svc.flush)
    for q in stream[:16]:    # resubmit a prefix: the LRU cache serves these
        svc.submit(q)
    timed("Query service (16 cached)", svc.flush)
    reach = svc.result(tickets[0])
    print(f"\n  service stats          {svc.stats}")
    print(f"  first query            {stream[0]} -> {reach}")
    out = {"spmspv_sum": float(ys.sum()), "spmspv_kernel_sum":
           float(ys_k[:g.n_rows].sum()), "service_queries": svc.stats.queries}

    if use_dist:
        from repro_torch.launch.mesh import spawn
        with tempfile.TemporaryDirectory() as tmp:
            out["distributed"] = spawn(
                distributed_demo, args.ranks, device=dev,
                init_file=os.path.join(tmp, "init"),
                args=(args.scale, args.placement, args.sync_interval,
                      args.trace))[0]
    else:
        print("\n  distributed serving demo skipped (--ranks < 2)")
    if obs is not None:
        out["trace_events"] = _export(obs, args.trace)

    if args.stream > 0:
        out["stream"] = _stream(g, args.stream, dev)

    out.update(
        pagerank_mass=float(pr.sum()), bfs_reached=int((lv >= 0).sum()),
        sssp_reached=int(torch.isfinite(dist).sum()),
        components=int(torch.unique(comp).numel()),
        communities=int(torch.unique(lab).numel()),
        modularity=float(modularity(g, lab)),
        multilevel_communities=int(torch.unique(mlab).numel()),
        multilevel_modularity=float(mscores[-1]) if mscores else 0.0,
        multilevel_levels=len(mscores), ties_nodes=int(n_nodes),
        ties_edges=int(mask.sum()))
    print(f"\n  pagerank mass          {out['pagerank_mass']:.4f}")
    print(f"  bfs reached            {out['bfs_reached']}/{g.n_rows}")
    print(f"  sssp reached           {out['sssp_reached']}/{g.n_rows}")
    print(f"  components             {out['components']}")
    print(f"  communities            {out['communities']}")
    print(f"  modularity             {out['modularity']:.4f}")
    print(f"  multilevel communities {out['multilevel_communities']}")
    print(f"  multilevel modularity  {out['multilevel_modularity']:.4f} "
          f"over {out['multilevel_levels']} levels")
    print(f"  TIES nodes/edges       {out['ties_nodes']}/{out['ties_edges']}")
    return out


if __name__ == "__main__":
    main()
