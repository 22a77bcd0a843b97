#!/usr/bin/env python3
"""Smoke run of the torch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--scale 20] [--out build/chip_smoke.json]

Phases, each of which exits non-zero on failure:

1. device: the card's name, capability, and its name and power limit as
   ``nvidia-smi`` reports them;
2. build: compiles ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a);
   then the tune phase (``[tune]`` lines): ``repro_torch.tune.autotune``
   at scale 16 on the card (B1 / B3 timed per BBCSR geometry, the 'add'
   geometries gated to the default's bits), written to
   ``build/tuned_smoke.json``, not the committed file; ``kernel_rows`` at
   the run's scale (default vs tuned geometry per family, flash attention
   b4h8s1024 in f32, an 8k-lookup EmbeddingBag) and the STREAM-triad peak
   beside the nominal 3.35 TB/s; then, on the run's graph, the geometry
   ``build_pull_operand`` resolves per family, and where the committed
   'add' geometry is not the default, SpMV under both must give equal
   bits; ``tune.autotune_fallback`` must not move from there through
   connected components (a missing or misread tuned file would run
   defaults unseen);
3. kernel parity on an RMAT graph (``rmat(scale, 16, seed=7)``, the tile
   geometry of the committed card entry): each BBCSR kernel against its
   plain torch version on the card — SpMV (B1), SpMSpV 'add' on a
   frontier touching about 1% of the column blocks (B2), SpMSpV 'min' /
   'max' all-active and sparse (B3); min/max exact, 'add' within rtol
   1e-5 / atol 1e-5; B1 and B2 run twice on the same inputs must give
   equal bits (``[repro]``);
4. the main path through the port's public entry points, each path with
   the launch counts zeroed just before it and read just after: SpMV,
   BFS on the unit pull operand, SSSP on the (min,+) operand (both against
   the plain engine, bit-equal), PageRank (mass 1 within 1e-3) and
   connected components (BFS's kernel path also over 10 warm runs, beside
   its operand's unit-value check); then the batched lanes at B = 32
   sources (vertex 0 and 31 drawn from the vertices with out-edges), each
   run while its operand from the scalar path is alive: ``msbfs`` (bit-packed lanes,
   the ``segment_or`` kernel; every lane bit-equal to a scalar BFS),
   ``run_batched(ppr_program, kernel_bb=unit operand)`` (B2 per lane)
   against ``ppr_batched`` (rtol / atol 1e-5, each lane's mass 1 within
   1e-3) and ``ppr_topk``, and ``sssp_batched`` on the (min,+) operand (B3
   per lane) against its plain path (bit-equal, equal stats, four lanes
   bit-equal to a scalar SSSP); ``segment_or`` alone on the dense step's
   stream, bit-equal to its plain version and timed beside its byte bound;
   a vmap fallback warning on the valued lanes fails the run; then the
   local graph query service on the same graph while those results are
   alive (``[service]`` lines): ``GraphService(batch_budget=32,
   cache_capacity=4096, obs=Observability())`` answers, per batched source,
   4 Reachability and 4 Distance queries (targets from
   ``np.random.default_rng(1)``) and one PPRTopK(k=10), and 64
   NeighborSample draws; each answer is held to phase 4's ``msbfs`` levels,
   plain ``sssp_batched`` distances (bit-equal; the service's ``auto_delta``
   must be phase 4's delta) and ``ppr_topk`` (1e-5), each pick to the
   graph's rows; the same stream again must be all cache hits; the trace
   it exports (``build/service_trace.json``) must pass
   ``validate_chrome_trace``; then 4,096 inserts confined to the last
   partition must leave the other partitions' samples cached, and a
   re-asked Distance must equal a fresh ``sssp_batched`` on the updated
   graph bit for bit; ``segment_or`` must be launched in the phase; then,
   after connected components, the structured phase on the same graph
   (``[structured]`` lines, each path with the counts zeroed just before
   it): ``label_propagation(iters=8)`` twice (equal bits) and at RMAT-16
   on the card against the CPU path (equal bits); ``segment_mode`` alone
   on the LPA dense step's sorted stream and ``run_sum`` alone on
   ``contract``'s stream, each bit-equal to its plain version and timed
   beside its byte bound; ``multilevel`` per level (wall, sweeps, vertices
   and edges after contraction, Q), twice (equal labels and scores), Q
   against ``modularity`` (1e-6), the contracted graph's Q (1e-5) and a
   single LPA sweep's, and at RMAT-16 card against CPU (equal bits);
   ``random_walks`` (one walker per vertex, 80 steps: every step an
   out-edge or a sink staying put), a chi-square of 1 M unweighted and 1 M
   weighted ``sample_neighbors`` draws at the largest hub (p > 1e-4),
   ``neighbor_sample`` with fanouts (25, 10) over 1,024 seeds (every pick
   valid), ``ties_sample`` of 1% of the edges (its invariants); 4,096
   random inserts through ``GraphHandle.apply``, after which
   ``repair_or_recompute`` of phase 4's BFS, SSSP and CC results must be
   bit-equal to fresh runs, and a batch with deletes must take the
   counted fallback; ``segment_mode`` and ``run_sum`` must be launched;
5. kernel timings with CUDA events beside their byte bound, the plain
   version and, where one exists, a library call computing the same
   function (timed here only; the port never calls it), and B1 / B3 on the
   heaviest row block's tiles alone beside the full launch (``[time]
   heaviest row block``: does the launch follow that block?);
6. ops: the kernel entry point ``repro_torch.kernels.ops`` at the repo's
   configs' full widths, each call with its kernel's launch count zeroed
   just before it and read just after, each kernel held against its plain
   version on the same inputs and timed beside its bound, the plain version
   and a library call: ``segment_sum_sorted`` (B4) on gin-tu's aggregation
   over the RMAT graph's in-edges (d 64), ``embedding_bag`` (B5) on fm
   serving (39 fields x 1M rows: ``serve_bulk`` batch 262,144 as a sum and
   as a weighted mean with 10% of ids -1, ``serve_p99`` batch 512 as a
   sum, each with the bytes of its rows' 32-byte sectors beside its byte
   bound, for information), ``flash_attention`` (B6)
   at qwen3-14b prefill 4096 and decode over 32768 keys at batch 128 and
   at batch 1 and at mixtral-8x7b's 4096-token window over 8192; each B6
   call must take the path the wrapper's dispatch rule gives it (the
   wgmma kernel for prefill and window, the folded kernel with its keys
   split for the batch-1 decode, unsplit at batch 128), read from the
   per-path launch counts, and its case names that path.

Prints one JSON line ``{"kernels": [...]}`` (eight kernels) and, last, the
device line.
The segment_mode entry's times are those of the weighted mode on the LPA
stream; its launches cover both entry points of ``csrc/segment_mode.cu``
on the structured phase's paths (``entry_launches`` splits them), and
``run_sum``'s own numbers are in its ``cases``.
The embedding_bag entry's times are those of the bulk sum; its launches
and max_abs_err cover the three checked calls, and each case's own numbers
are in its ``cases``.
The flash_attention entry's times are those of one shape, the one
furthest from its bound, named in its ``shape`` key; its launches and
max_abs_err cover every checked call; each shape's own numbers are in its
``cases``.
Needs one card; on a host without one it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor cores
ADD_RTOL = ADD_ATOL = 1e-5         # kernel vs plain, f32 'add'
# B4: f32 atomics in no fixed order, runs of up to ~1e5 rows (RMAT hubs),
# against a float64-accumulated plain version
SEG_TOL = 1e-4
# B5: each bag is summed in stream order in f32, 39 rows: a few ulps of
# the float64-accumulated plain version
BAG_TOL = 1e-5
# B6 bf16: the kernel rounds the probabilities to bf16 for the second
# product and the output to bf16 (2^-8 relative each); the plain version
# runs in f32 and rounds once.  Each (b, head, position) row is held to
# ||kernel - plain|| / ||plain|| <= ATTN_ROW_TOL, and each element to
# rtol ATTN_TOL plus atol ATTN_TOL times min(1, the plain row's RMS): rows
# that average thousands of keys sit near 0.03, so an absolute 5e-2 would
# pass a wrong kernel.  A planted fault (each row's own 64-key block, the
# last one the kernel visits, left out) must fail the same check.
ATTN_TOL = 5e-2
ATTN_ROW_TOL = 1e-2
FAULT_BLOCK = 64
LANES = 32                         # the reference service's micro-batch
BFS_RUNS = 10                      # warm BFS kernel-path runs, timed apart
PPR_TOL = 1e-5                     # batched PPR, kernel vs plain path
SERVICE_INSERTS = 4096             # the service phase's edge update
LPA_ITERS = 8                      # configs/piuma_graph.py lpa_iters
SMALL_SCALE = 16                   # card vs CPU path
WALK_STEPS = 80                    # DeepWalk's walk length
SAMPLE_DRAWS = 1_000_000           # chi-square draws at the largest hub
SAGE_FANOUTS, SAGE_SEEDS = (25, 10), 1024   # GraphSAGE's fanouts
REPAIR_INSERTS = 4096
SERVICE_TRACE = os.path.join(ROOT, "build", "service_trace.json")
TUNE_SCALE = 16                    # the phase's sweep; the CLI sweeps 20
TUNE_OUT = os.path.join(ROOT, "build", "tuned_smoke.json")
TILE = ("block_rows", "block_cols", "tile_nnz")
SOURCE = {"spmv_bbcsr": "src/repro_torch/csrc/bbcsr.cu",
          "spmspv_bbcsr_add": "src/repro_torch/csrc/bbcsr.cu",
          "spmspv_bbcsr_select": "src/repro_torch/csrc/bbcsr.cu",
          "segment_sum": "src/repro_torch/csrc/segment_sum.cu",
          "segment_or": "src/repro_torch/csrc/segment_or.cu",
          "segment_mode": "src/repro_torch/csrc/segment_mode.cu",
          "embedding_bag": "src/repro_torch/csrc/embedding_bag.cu",
          "flash_attention": "src/repro_torch/csrc/flash_attention.cu"}
REPLACES = {"spmv_bbcsr": "src/repro/kernels/spmv_dma.py:206",
            "spmspv_bbcsr_add": "src/repro/kernels/spmv_dma.py:235",
            "spmspv_bbcsr_select": "src/repro/kernels/spmv_dma.py:235",
            "segment_sum": "src/repro/kernels/segment_sum.py:45",
            "segment_or": "src/repro/core/offload.py:154 (plain jnp, no "
                          "Pallas kernel)",
            "segment_mode": "src/repro/core/offload.py:124 (plain jnp, no "
                            "Pallas kernel)",
            "embedding_bag": "src/repro/kernels/embedding_bag.py:43",
            "flash_attention": "src/repro/kernels/flash_attention.py:75"}


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def host_s(fn) -> float:
    """Host wall seconds of fn() up to the end of its device work."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(bb, tile_active=None) -> float:
    """Least time at the card's memory rate for the bytes the kernel must
    move on these inputs: 12 B per real slot of the tiles it processes,
    their tile_cb and tile_cnt, the tile_active flags (SpMSpV), rb_ptr, x
    (padded) and y."""
    import torch
    live = bb.tile_cnt if tile_active is None else \
        torch.where(tile_active != 0, bb.tile_cnt, 0)
    n_live = bb.n_tiles if tile_active is None else \
        int((tile_active != 0).sum())
    nbytes = (12 * int(live.long().sum()) + 8 * n_live
              + (0 if tile_active is None else 4 * bb.n_tiles)
              + 4 * (bb.n_row_blocks + 1)
              + 4 * bb.n_col_blocks * bb.block_cols + 4 * bb.n_rows)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def heaviest_block_diagnostic(bb, rb_slots, x, all_act, reps: int) -> dict:
    """Times B1 and B3 (min, all active) on the full operand and on a
    sub-operand holding only the heaviest row block's tile range (rows
    local to that block).  If the block alone takes most of the full
    launch, the launch follows its heaviest row block."""
    import torch
    from repro_torch.core.graph import BBCSR
    from repro_torch.kernels import spmv_dma as K
    b = int(rb_slots.argmax())
    lo, hi = int(bb.rb_ptr[b]), int(bb.rb_ptr[b + 1])
    sub = BBCSR(bb.rows_local[lo:hi], bb.cols_local[lo:hi], bb.vals[lo:hi],
                torch.zeros(hi - lo, dtype=torch.int32, device="cuda"),
                bb.tile_cb[lo:hi].contiguous(),
                bb.tile_init[lo:hi].contiguous(), bb.block_rows, bb.n_cols,
                bb.block_rows, bb.block_cols, bb.tile_nnz,
                tile_cnt=bb.tile_cnt[lo:hi].contiguous(),
                rb_ptr=torch.tensor([0, hi - lo], dtype=torch.int32,
                                    device="cuda"),
                nnz=int(bb.tile_cnt[lo:hi].long().sum()))
    sub_act = all_act[:hi - lo]
    out = dict(
        row_block=b, tiles=hi - lo, real_slots=int(rb_slots[b]),
        spmv_full_ms=cuda_ms(lambda: K.spmv_bbcsr_kernel_call(bb, x), reps),
        spmv_alone_ms=cuda_ms(lambda: K.spmv_bbcsr_kernel_call(sub, x), reps),
        min_full_ms=cuda_ms(lambda: K.spmspv_bbcsr_kernel_call(
            bb, x, all_act, combine="min"), reps),
        min_alone_ms=cuda_ms(lambda: K.spmspv_bbcsr_kernel_call(
            sub, x, sub_act, combine="min"), reps))
    log(f"[time] heaviest row block {b} ({hi - lo} tiles, "
        f"{out['real_slots']} real slots): B1 full {out['spmv_full_ms']!r} "
        f"ms, block alone {out['spmv_alone_ms']!r} ms; B3 min all-active "
        f"full {out['min_full_ms']!r} ms, block alone "
        f"{out['min_alone_ms']!r} ms")
    return out


def tune_phase(args) -> dict:
    """The sweep at TUNE_SCALE on the card (into TUNE_OUT), the kernel
    measurement lane at the run's scale and the STREAM peak.  Returns the
    phase's numbers."""
    import torch
    from repro_torch import tune
    from repro_torch.tune.sweep import format_entry
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    entry = tune.autotune(TUNE_SCALE, reps=3)
    sweep_s = time.perf_counter() - t_phase
    with open(TUNE_OUT, "w") as fh:
        json.dump({"version": 1, "tool": "chip_smoke.py",
                   "entries": [entry]}, fh, indent=1, sort_keys=True)
    for line in format_entry(entry):
        log(f"[tune] (cuda, {TUNE_SCALE}) {line}")
    committed = tune.lookup("cuda", TUNE_SCALE)
    same = committed is not None and committed["scale"] == TUNE_SCALE and \
        all(committed["params"][k] == v for k, v in entry["params"].items()
            if k.startswith("kernels.bbcsr"))
    log(f"[tune] sweep at scale {TUNE_SCALE}: {sweep_s!r} s, written to "
        f"{os.path.relpath(TUNE_OUT, ROOT)}; its winners equal the "
        f"committed entry's: {same}")
    t0 = time.perf_counter()
    rows = tune.kernel_rows(args.scale, reps=3)
    for r in rows:
        cfg = "/".join(str(r["config"][k]) for k in TILE) \
            if "config" in r else ""
        # bytes_model is the reference's TPU stream model (whole padded
        # tiles, and for 'min' a whole BFS), not the bytes the port's
        # kernel moves: its rate is a ranking figure, not a device rate
        log(f"[tune] kernel_rows {r['name']} {cfg}: {r['us']!r} us "
            f"({r['measured']}); the reference's byte model "
            f"{r['bytes_model']} B, {r['bytes_per_s'] / 1e9!r} GB/s by it")
    rows_s = time.perf_counter() - t0
    peak = tune.stream_peak_bytes_per_s()
    log(f"[tune] STREAM triad peak {peak / 1e12!r} TB/s: "
        f"{peak / HBM_BYTES_PER_S!r} of the nominal "
        f"{HBM_BYTES_PER_S / 1e12!r} TB/s")
    out = {"sweep": entry, "sweep_s": sweep_s, "winners_committed": same,
           "kernel_rows": rows, "kernel_rows_s": rows_s,
           "stream_peak_bytes_per_s": peak,
           "phase_s": time.perf_counter() - t_phase,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"[tune] phase wall {out['phase_s']!r} s")
    log(f"[mem] tune phase peak allocated {out['peak_gib']:.2f} GiB")
    torch.cuda.empty_cache()
    return out


def tuned_geometry(g, x) -> dict:
    """The geometry build_pull_operand resolves on ``g`` per family (it
    must come from the committed card entry); where the 'add' geometry is
    not the default, SpMV under both must give equal bits.  Both operands
    are freed."""
    import torch
    from repro_torch import tune
    from repro_torch.core import engine
    from repro_torch.kernels import spmv_dma as K
    entry = tune.lookup("cuda", tune.scale_of(g.n_rows))
    if entry is None:
        fail(f"the committed tuned file has no card entry within "
             f"{tune.SCALE_WINDOW} of scale {tune.scale_of(g.n_rows)}")
    geo = {fam: {k: tune.resolve(f"kernels.{fam}.{k}", n=g.n_rows,
                                 device=g.device) for k in TILE}
           for fam in ("bbcsr_add", "bbcsr_min")}
    for fam, cfg in geo.items():
        log(f"[tune] rmat graph resolves {fam} "
            f"{'/'.join(str(cfg[k]) for k in TILE)} from the card entry at "
            f"scale {entry['scale']} ({entry['device']}, "
            f"{entry['power_limit']})")
    default = {k: tune.DEFAULTS[f"kernels.bbcsr_add.{k}"] for k in TILE}
    if geo["bbcsr_add"] == default:
        log("[tune] the committed 'add' geometry is the default: SpMV runs "
            "under one geometry")
        return geo
    y_t = K.spmv_bbcsr_kernel_call(engine.build_pull_operand(g), x)
    y_d = K.spmv_bbcsr_kernel_call(engine.build_pull_operand(g, **default),
                                   x)
    torch.cuda.synchronize()
    same = torch.equal(y_t, y_d)
    log(f"[tune] SpMV under the tuned and the default 'add' geometry "
        f"bit-equal: {same}")
    if not same:
        fail("the tuned 'add' geometry changes SpMV's bits on this graph")
    del y_t, y_d
    torch.cuda.empty_cache()
    return geo


def masked_attention(q, k, v, mask):
    """The plain attention of ``ref.flash_attention_ref`` under an explicit
    (Sq, Skv) mask (True where the key takes part), in q.dtype: builds the
    B6 check's planted fault."""
    import torch
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    mask = mask.repeat(g, 1)
    out = torch.empty_like(q)
    for b in range(B):
        logits = torch.matmul(q[b].reshape(Hkv, g * Sq, D).float(),
                              k[b].float().transpose(1, 2)) * D ** -0.5
        logits.masked_fill_(~mask, float("-inf"))
        p = torch.softmax(logits, dim=-1).nan_to_num_(nan=0.0)
        out[b] = torch.matmul(p, v[b].float()).reshape(Hq, Sq, D).to(q.dtype)
    return out


def ops_phase(args, seg, n_vertices: int, err: dict) -> dict:
    """Phase 6: the kernel entry point at the configs' widths.  Returns,
    per kernel, its launches in the checked calls and its timings; writes
    each kernel's largest |kernel - plain| into ``err``."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import segment_sum as SS

    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = {}

    def called(mod, key, fn):
        """fn() with mod's launch count zeroed just before and read just
        after; fails unless the kernel launched."""
        mod.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        count = mod.LAUNCHES[key]
        if count == 0:
            fail(f"{key}: the entry point did not launch its kernel")
        return out, count

    def shaped(label, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"{label}: shape {tuple(got.shape)} (want "
                 f"{tuple(want.shape)}) or non-finite values")

    def held(entry, label, got, want, tol):
        """got within rtol tol and atol tol of want; returns the largest
        |got - want|."""
        shaped(label, got, want)
        d = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=tol, atol=tol))
        log(f"[ops] {label}: max |kernel - plain| = {d!r} (rtol/atol {tol}); "
            f"max |plain| {float(want.abs().max())!r}")
        if not ok:
            fail(f"{label}: kernel disagrees with the plain version")
        err[entry] = max(err.get(entry, 0.0), d)
        return d

    def attention_reading(got, want):
        """(largest per-row ||got - want|| / ||want||, largest element's
        |got - want| over its limit): got passes iff the first is at most
        ATTN_ROW_TOL and the second at most 1."""
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        row = diff.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
        rms = want.pow(2).mean(-1, keepdim=True).sqrt()
        limit = ATTN_TOL * (want.abs() + rms.clamp(max=1.0))
        return (float(row.max()),
                float((diff / limit.clamp_min(1e-30)).max()))

    def held_attention(label, got, want, faulty):
        """The B6 check on the kernel, and on a planted fault, which must
        fail it.  Returns the kernel's largest |kernel - plain|, and the
        kernel's and the fault's largest per-row relative error."""
        shaped(label, got, want)
        k_row, k_el = attention_reading(got, want)
        f_row, f_el = attention_reading(faulty, want)
        d = float((got.float() - want.float()).abs().max())
        log(f"[ops] {label}: max |kernel - plain| = {d!r}; per row max "
            f"||kernel - plain|| / ||plain|| = {k_row!r} (limit "
            f"{ATTN_ROW_TOL}), element max {k_el!r} of its limit; planted "
            f"fault: row {f_row!r}, element {f_el!r} of its limit")
        if k_row > ATTN_ROW_TOL or k_el > 1.0:
            fail(f"{label}: kernel disagrees with the plain version")
        if f_row <= ATTN_ROW_TOL and f_el <= 1.0:
            fail(f"{label}: the planted fault passes the check")
        err["flash_attention"] = max(err.get("flash_attention", 0.0), d)
        return d, k_row, f_row

    # -- B4: gin-tu's sum aggregation over RMAT in-edges ---------------------
    d_hidden = 64                         # configs/gin_tu.py d_hidden
    n_e = seg.numel()
    data = torch.randn(n_e, d_hidden, device="cuda", generator=gen)
    out, cnt = called(SS, "segment_sum", lambda: ops.segment_sum_sorted(
        data, seg, n_vertices))
    held("segment_sum", f"B4 segment_sum ({n_e}, {d_hidden}) -> "
         f"({n_vertices}, {d_hidden})", out,
         ref.segment_sum_ref(data, seg, n_vertices), SEG_TOL)
    del out
    lib_out = torch.zeros(n_vertices, d_hidden, device="cuda")
    rows["segment_sum"] = dict(
        launches=cnt,
        ms=cuda_ms(lambda: ops.segment_sum_sorted(data, seg, n_vertices),
                   args.reps),
        plain_ms=cuda_ms(lambda: ref.segment_sum_ref(data, seg, n_vertices),
                         3, 1),
        # data and seg read once, out written once
        bound_ms=1e3 * (4 * n_e * d_hidden + 4 * n_e
                        + 4 * n_vertices * d_hidden) / HBM_BYTES_PER_S,
        bound_by="bytes",
        library_ms=cuda_ms(lambda: lib_out.index_add_(0, seg, data),
                           args.reps))
    del data, lib_out, seg
    torch.cuda.empty_cache()

    # -- B5: fm serving, bulk and p99 batches -------------------------------
    n_fields, per_field, emb = 39, 1_000_000, 10      # configs/fm.py
    batch = 262_144                       # configs/common.py serve_bulk
    batch_p99 = 512                       # configs/common.py serve_p99
    v_rows = -(-n_fields * per_field // 512) * 512
    d = 1 + emb                           # linear + latent, one table
    table = torch.randn(v_rows, d, device="cuda", generator=gen)
    # ids as data/synthetic.py draws them: Zipf(1.2) per field, plus the
    # field's offset; each sample is one bag of its 39 lookups
    rng = np.random.default_rng(12)

    def fm_stream(n_samples):
        local = rng.zipf(1.2, size=(n_samples, n_fields)) % per_field
        ids = (local + np.arange(n_fields)[None, :] * per_field).astype(
            np.int32)
        return (torch.from_numpy(ids.reshape(-1)).cuda(),
                torch.arange(n_samples, dtype=torch.int32, device="cuda"
                             ).repeat_interleave(n_fields))

    idx, bag = fm_stream(batch)
    n_look = idx.numel()
    out, cnt = called(EB, "embedding_bag", lambda: ops.embedding_bag(
        table, idx, bag, batch))
    err_sum = held("embedding_bag", f"B5 embedding_bag sum ({n_look} "
                   f"lookups, {batch} bags, d {d})", out,
                   ref.embedding_bag_ref(table, idx, bag, batch), BAG_TOL)
    idx_pad = torch.where(torch.rand(n_look, device="cuda", generator=gen)
                          < 0.1, -1, idx)
    w = torch.rand(n_look, device="cuda", generator=gen)
    out_m, cnt_m = called(EB, "embedding_bag", lambda: ops.embedding_bag(
        table, idx_pad, bag, batch, w, "mean"))
    err_mean = held(
        "embedding_bag", "B5 embedding_bag weighted mean, 10% ids -1", out_m,
        ref.embedding_bag_ref(table, idx_pad, bag, batch, w, "mean"), BAG_TOL)
    idx_p99, bag_p99 = fm_stream(batch_p99)
    out_p, cnt_p = called(EB, "embedding_bag", lambda: ops.embedding_bag(
        table, idx_p99, bag_p99, batch_p99))
    err_p99 = held("embedding_bag", f"B5 embedding_bag serve_p99 sum "
                   f"({idx_p99.numel()} lookups, {batch_p99} bags)", out_p,
                   ref.embedding_bag_ref(table, idx_p99, bag_p99, batch_p99),
                   BAG_TOL)
    del out, out_m, out_p

    def bag_bytes(ix, n_bags, weighted):
        """(bytes of idx and bag read once, the weights too, and out written
        once; bytes of the distinct valid rows; those rows' bytes in the
        32-byte sectors they span; the number of those rows)."""
        rows_read = torch.unique(ix[ix >= 0]).long()
        first = rows_read * (4 * d) // 32
        last = (rows_read * (4 * d) + 4 * d - 1) // 32
        n = ix.numel()
        return (4 * n * (3 if weighted else 2) + 4 * n_bags * d,
                4 * d * rows_read.numel(),
                32 * int((last - first + 1).sum()), rows_read.numel())

    def library(ix, bg, n_bags):
        off = torch.searchsorted(bg, torch.arange(n_bags, dtype=bg.dtype,
                                                  device="cuda"))
        ix64 = ix.long()
        return lambda: F.embedding_bag(ix64, table, off, mode="sum")

    cases = []
    for label, ix, bg, n_bags, wt, mode, launched, d_err in (
            ("fm serve_bulk sum", idx, bag, batch, None, "sum", cnt,
             err_sum),
            ("fm serve_bulk weighted mean, 10% ids -1", idx_pad, bag, batch,
             w, "mean", cnt_m, err_mean),
            ("fm serve_p99 sum", idx_p99, bag_p99, batch_p99, None, "sum",
             cnt_p, err_p99)):
        stream_b, row_b, sector_b, n_distinct = bag_bytes(
            ix, n_bags, wt is not None)
        case = dict(
            case=label, n_lookups=ix.numel(), n_bags=n_bags, d=d,
            launches=launched, max_abs_err=d_err,
            # the kernel wrapper on the bag-sorted stream (the entry point's
            # sentinels and sort are glue, timed apart below)
            ms=cuda_ms(lambda: EB.embedding_bag_kernel_call(
                table, ix, bg, n_bags, wt, mode=mode), args.reps),
            plain_ms=cuda_ms(lambda: ref.embedding_bag_ref(
                table, ix, bg, n_bags, wt, mode), 3, 1),
            bound_ms=1e3 * (stream_b + row_b) / HBM_BYTES_PER_S,
            bound_by="bytes",
            # F.embedding_bag takes per-sample weights only for 'sum', and
            # no -1 ids: the weighted mean has no single library call
            library_ms=None if wt is not None else cuda_ms(
                library(ix, bg, n_bags), args.reps))
        log(f"[time] embedding_bag {label}: kernel {case['ms']!r} ms, plain "
            f"{case['plain_ms']!r} ms, bound {case['bound_ms']!r} ms, "
            f"library {case['library_ms']!r} ms")
        log(f"[ops] B5 {label}: {n_distinct} distinct rows of {v_rows}: "
            f"{row_b} B as rows, {sector_b} B in the 32-byte sectors they "
            f"span; byte bound {case['bound_ms']!r} ms, "
            f"{1e3 * (stream_b + sector_b) / HBM_BYTES_PER_S!r} ms counting "
            f"the rows' sectors (information only, no limit uses it)")
        cases.append(case)
    entry_ms = cuda_ms(lambda: ops.embedding_bag(table, idx, bag, batch), 5)
    log(f"[ops] B5: entry point with its sort {entry_ms!r} ms")
    # B5's times are the bulk sum's; its launches cover all three checked
    # calls
    rows["embedding_bag"] = dict(
        launches=sum(c["launches"] for c in cases),
        **{key: cases[0][key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
        cases=cases)
    del table, idx, bag, idx_pad, w, idx_p99, bag_p99
    torch.cuda.empty_cache()

    # -- B6: qwen3-14b prefill and decode, mixtral-8x7b window ---------------
    cases = []
    shapes = [  # label, B, Hq, Hkv, Sq, Skv, window, the path it must take
        ("qwen3-14b prefill", 1, 40, 8, 4096, 4096, None, "wgmma"),
        ("qwen3-14b decode", 128, 40, 8, 1, 32768, None, "mma"),
        ("mixtral-8x7b window", 1, 32, 8, 8192, 8192, 4096, "wgmma"),
        ("qwen3-14b decode batch 1", 1, 40, 8, 1, 32768, None, "mma split")]
    D = 128
    for label, B, Hq, Hkv, Sq, Skv, window, want_path in shapes:
        q = torch.randn(B, Hq, Sq, D, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        k = torch.randn(B, Hkv, Skv, D, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        v = torch.randn(B, Hkv, Skv, D, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        out, cnt = called(FA, "flash_attention", lambda: ops.flash_attention(
            q, k, v, causal=True, window=window))
        # the path the per-path counts say the call took
        took = "wgmma" if FA.LAUNCHES["flash_attention_wgmma"] else \
            "mma split" if FA.LAUNCHES["flash_attention_split"] else "mma"
        if took != want_path:
            fail(f"B6 {label}: took the {took} path, the dispatch rule "
                 f"gives {want_path}")
        visible = ref.attention_mask(Sq, Skv, True, window, "cuda")
        # the planted fault: each row's own key block left out
        qpos = torch.arange(Sq, device="cuda")[:, None] + (Skv - Sq)
        kpos = torch.arange(Skv, device="cuda")[None, :]
        faulty = masked_attention(
            q, k, v, visible & (kpos // FAULT_BLOCK != qpos // FAULT_BLOCK))
        d, row, row_fault = held_attention(
            f"B6 {label} B{B} Hq{Hq} Hkv{Hkv} Sq{Sq} Skv{Skv} window "
            f"{window}", out,
            ref.flash_attention_ref(q, k, v, causal=True, window=window),
            faulty)
        del out, faulty, qpos, kpos
        # operations on the visible (query, key) pairs only, 4 D each
        by_ops = 4 * D * B * Hq * int(visible.sum()) / BF16_FLOP_PER_S
        by_bytes = 2 * (2 * q.numel() + 2 * k.numel()) / HBM_BYTES_PER_S
        # prefill: is_causal (Sq == Skv, so both alignments agree); decode:
        # Sq = 1 at the last position sees every key, so no mask; window: an
        # explicit band, in torch's convention (True where the key takes
        # part)
        band = None if window is None else visible

        def lib():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=band, is_causal=band is None and Sq > 1,
                enable_gqa=True)
        case = dict(
            shape=label, B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Skv=Skv, window=window,
            path=took, launches=cnt, max_abs_err=d, row_err=row,
            row_err_fault=row_fault,
            ms=cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                   window=window), args.reps),
            plain_ms=cuda_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=True, window=window), 3, 1),
            bound_ms=1e3 * max(by_ops, by_bytes),
            bound_by="operations" if by_ops >= by_bytes else "bytes",
            library_ms=cuda_ms(lib, args.reps))
        log(f"[time] flash_attention {label} ({took}): kernel "
            f"{case['ms']!r} ms, plain {case['plain_ms']!r} ms, bound "
            f"{case['bound_ms']!r} ms "
            f"({case['bound_by']}), library {case['library_ms']!r} ms")
        cases.append(case)
        del q, k, v, band, visible
        torch.cuda.empty_cache()

    # B6's times are those of the shape furthest from its bound, named in
    # "shape"; its launches cover all four checked calls
    worst = max(cases, key=lambda c: c["ms"] / c["bound_ms"])
    rows["flash_attention"] = dict(
        launches=sum(c["launches"] for c in cases), shape=worst["shape"],
        **{key: worst[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
        cases=cases)
    for k in ("segment_sum", "embedding_bag"):
        t = rows[k]
        log(f"[time] {k}: kernel {t['ms']!r} ms, plain {t['plain_ms']!r} "
            f"ms, bound {t['bound_ms']!r} ms, library {t['library_ms']!r} "
            f"ms")
    return rows


@contextlib.contextmanager
def no_vmap_fallback():
    """A context in which torch.func.vmap's per-lane fallback (an op with
    no batching rule, which loops over the lanes) raises instead of
    warning."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield


def batched_ppr(g, bb_u, sources, path, path_launches):
    """PPR at B lanes: the B2 kernel per lane on the unit operand against
    the plain batched path, each lane's mass, and ppr_topk.  Returns
    ppr_topk's (scores, ids)."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core.algorithms import ppr_batched, ppr_program, ppr_topk
    n, B = g.n_rows, len(sources)
    src = torch.as_tensor(sources, device="cuda").long()

    def ppr_kernel():
        r = torch.zeros((B, n), device="cuda")
        r[torch.arange(B, device="cuda"), src] = 1.0
        return engine.run_batched(
            g, ppr_program(g, 0.85), {"x": r, "r": r},
            torch.ones((B, n), dtype=torch.int32, device="cuda"),
            max_iters=20, mode="pull", kernel_bb=bb_u, return_stats=True)

    with no_vmap_fallback():
        st_k, stats_k = path("ppr_batched kernel_bb", ppr_kernel)
        x_p, stats_p = path("ppr_batched (plain)", lambda: ppr_batched(
            g, sources, return_stats=True))
        top_v, top_i = path("ppr_topk (plain)", lambda: ppr_topk(
            g, sources, 10))
    x_k = st_k["x"]
    d = float((x_k - x_p).abs().max())
    log(f"[check] batched ppr kernel vs plain: max diff {d!r} (rtol/atol "
        f"{PPR_TOL}); stats kernel {stats_k} plain {stats_p}")
    if not (torch.isfinite(x_k).all() and torch.allclose(
            x_k, x_p, rtol=PPR_TOL, atol=PPR_TOL)):
        fail("batched PPR: the kernel path disagrees with the plain path")
    mass = x_k.double().sum(1)
    log(f"[check] batched ppr mass per lane: min {float(mass.min())!r} max "
        f"{float(mass.max())!r}")
    if float((mass - 1.0).abs().max()) > 1e-3:
        fail("batched PPR: a lane's mass is not 1 within 1e-3")
    if path_launches["ppr_batched kernel_bb"]["spmspv_bbcsr_add"] == 0:
        fail("batched PPR did not launch spmspv_bbcsr_add")
    # top-10 id sets agree on every lane whose 10th and 11th scores (plain)
    # differ by more than the tolerance
    srt = torch.sort(x_p, dim=1, descending=True).values
    clear = (srt[:, 9] - srt[:, 10]) > PPR_TOL
    want = torch.topk(x_k, 10).indices
    same = (torch.sort(top_i.long(), 1).values
            == torch.sort(want, 1).values).all(1)
    log(f"[check] ppr_topk: {int(clear.sum())} of {B} lanes with a clear "
        f"10th score, ids agree on {int((same & clear).sum())}; scores max "
        f"diff {float((top_v - torch.topk(x_k, 10).values).abs().max())!r}")
    if not bool(same[clear].all()) or top_v.shape != (B, 10):
        fail("ppr_topk ids disagree with the kernel path's top 10")
    return top_v, top_i


def batched_msbfs(g, sources, lv_p, path, path_launches, err, args) -> dict:
    """MS-BFS at B lanes (packed words, the segment_or kernel), every lane
    against a scalar plain BFS; then segment_or alone on the dense step's
    stream.  Returns segment_or's row of the kernels line and the levels."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core.algorithms import bfs, msbfs
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_or as SO
    n, B = g.n_rows, len(sources)
    lv, stats = path("msbfs", lambda: msbfs(g, sources, return_stats=True))
    bad = [b for b, s in enumerate(sources)
           if not torch.equal(lv[b], lv_p if s == 0 else bfs(g, int(s)))]
    log(f"[check] msbfs {B} lanes: stats {stats}; lanes unequal to a scalar "
        f"bfs: {bad}; reached per lane min "
        f"{int((lv >= 0).sum(1).min())} max {int((lv >= 0).sum(1).max())}")
    if bad or not torch.equal(lv[0], lv_p):
        fail(f"msbfs lanes {bad} differ from the scalar BFS")
    if path_launches["msbfs"]["segment_or"] == 0:
        fail("msbfs did not launch segment_or")

    # segment_or alone: the dense step's stream, half of the lane bits set
    p_src, p_dst, _ = engine._dst_sorted(g)
    gen = torch.Generator(device="cuda").manual_seed(16)
    words = torch.randint(-2**31, 2**31, (n, engine.lane_words(B)),
                          dtype=torch.int32, device="cuda", generator=gen)
    w_e = words[p_src]
    m, W = w_e.shape
    got = SO.segment_or_kernel_call(p_dst, w_e, n)
    want = ref.segment_or_ref(p_dst, w_e, n)
    torch.cuda.synchronize()
    diff = int((got.long() - want.long()).abs().max())
    log(f"[parity] segment_or ({m}, {W}) -> ({n}, {W}): bit-equal "
        f"{torch.equal(got, want)}, max |kernel - plain| {diff}")
    if not torch.equal(got, want):
        fail("segment_or: kernel disagrees with the plain version")
    err["segment_or"] = float(diff)
    row = dict(
        ms=cuda_ms(lambda: SO.segment_or_kernel_call(p_dst, w_e, n),
                   args.reps),
        plain_ms=cuda_ms(lambda: ref.segment_or_ref(p_dst, w_e, n), 3, 1),
        # ids and words read once, out written once
        bound_ms=1e3 * (m * (4 + 4 * W) + n * 4 * W) / HBM_BYTES_PER_S,
        bound_by="bytes", library_ms=None)
    log(f"[time] segment_or: kernel {row['ms']!r} ms, plain "
        f"{row['plain_ms']!r} ms, bound {row['bound_ms']!r} ms, library "
        f"none")
    return row, lv


def batched_sssp(g, bb_m, sources, delta, path, path_launches):
    """SSSP at B lanes: B3 per lane on the (min,+) operand against the plain
    batched path, and four lanes against a scalar SSSP.  Returns the plain
    path's distances."""
    import torch
    from repro_torch.core.algorithms import sssp, sssp_batched
    with no_vmap_fallback():
        d_k, stats_k = path("sssp_batched kernel_bb", lambda: sssp_batched(
            g, sources, delta=delta, kernel_bb=bb_m, return_stats=True))
        d_p, stats_p = path("sssp_batched (plain)", lambda: sssp_batched(
            g, sources, delta=delta, return_stats=True))
    log(f"[check] sssp_batched kernel vs plain bit-equal "
        f"{torch.equal(d_k, d_p)}; stats kernel {stats_k} plain {stats_p}")
    if not torch.equal(d_k, d_p) or stats_k != stats_p:
        fail("sssp_batched: the kernel path differs from the plain path")
    for b in (0, 1, len(sources) // 2, len(sources) - 1):
        if not torch.equal(d_p[b], sssp(g, int(sources[b]), delta=delta)):
            fail(f"sssp_batched lane {b} differs from a scalar SSSP")
    log("[check] sssp_batched lanes 0, 1, B/2, B-1 bit-equal to scalar sssp")
    if path_launches["sssp_batched kernel_bb"]["spmspv_bbcsr_select"] == 0:
        fail("sssp_batched did not launch spmspv_bbcsr_select")
    return d_p


def service_phase(g, sources, lv, d_plain, top, delta, args) -> dict:
    """The local graph query service on phase 4's graph: a mixed stream
    (per source 4 Reachability and 4 Distance queries and one PPRTopK(10);
    64 NeighborSample draws) at batch_budget LANES with an Observability
    attached, flushed twice (the second pass all cache hits), then
    SERVICE_INSERTS inserts confined to the last partition.  Answers are
    held to phase 4's msbfs levels, plain sssp_batched distances and
    ppr_topk, picks to the graph's rows, the trace to its structural check.
    Returns the phase's numbers."""
    import numpy as np
    import torch
    from repro_torch.core import (Distance, GraphService, NeighborSample,
                                  PPRTopK, Reachability)
    from repro_torch.core.algorithms import auto_delta, sssp_batched
    from repro_torch.obs import (Observability, format_summary, summarize,
                                 validate_chrome_trace)
    n = g.n_rows
    lane = {}
    for b, s in enumerate(sources):
        lane.setdefault(int(s), b)
    rng = np.random.default_rng(1)
    stream = []
    for s in map(int, sources):
        stream += [Reachability(s, int(t)) for t in rng.integers(0, n, 4)]
        stream += [Distance(s, int(t)) for t in rng.integers(0, n, 4)]
        stream.append(PPRTopK(s, k=10))
    stream += [NeighborSample(int(v)) for v in rng.integers(0, n, 64)]

    obs = Observability()
    t0 = time.perf_counter()
    svc = GraphService(g, batch_budget=LANES, cache_capacity=4096, obs=obs)
    build_s = time.perf_counter() - t0
    log(f"[service] GraphService(batch_budget={LANES}, cache_capacity=4096,"
        f" obs) in {build_s!r} s; auto_delta {svc.delta!r}, phase 4's "
        f"{delta!r}")
    if svc.delta != delta:
        fail("the service's auto_delta differs from phase 4's delta")

    def serve(queries):
        tickets = [svc.submit(q) for q in queries]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.flush()
        torch.cuda.synchronize()
        return [svc.result(t) for t in tickets], time.perf_counter() - t0

    def same(a, b):
        if isinstance(a, tuple):
            return all(np.array_equal(x, y) for x, y in zip(a, b))
        return np.array_equal(a, b)

    answers, wall1 = serve(stream)
    batch_s = [(sp.args["kind"], sp.dur) for sp in obs.spans.spans()
               if sp.name == "engine"]
    readback_s = [(sp.args["kind"], sp.dur) for sp in obs.spans.spans()
                  if sp.name == "readback"]
    st1 = svc.stats.as_dict()
    again, wall2 = serve(stream)
    hits = svc.stats.cache_hits - st1["cache_hits"]
    log(f"[service] flush 1: {len(stream)} queries in {wall1!r} s, "
        f"{st1['batches']} batches; engine s per batch (host clock, ending "
        f"in the result's readback): {batch_s}; readback s per batch "
        f"(per-query answers, partition sets, ledger): {readback_s}")
    log(f"[service] flush 2: the same {len(stream)} queries in {wall2!r} s,"
        f" {hits} cache hits")
    if hits != len(stream) or svc.stats.batches != st1["batches"] or \
            not all(same(a, b) for a, b in zip(answers, again)):
        fail("service: the second pass was not served whole from the cache")

    lv_h, d_h = lv.cpu().numpy(), d_plain.cpu().numpy()
    top_v, top_i = (t.cpu().numpy() for t in top)
    bad, worst = {}, 0.0
    indptr, indices = g.indptr, g.indices
    for q, a in zip(stream, answers):
        kind = type(q).__name__
        if isinstance(q, Reachability):
            ok = a is bool(lv_h[lane[q.source], q.target] >= 0)
        elif isinstance(q, Distance):
            ok = np.float32(a).tobytes() == \
                d_h[lane[q.source], q.target].tobytes()
        elif isinstance(q, PPRTopK):
            ids, sc = a
            wv, wi = top_v[lane[q.source]], top_i[lane[q.source]]
            worst = max(worst, float(np.abs(sc - wv).max()))
            gaps = np.abs(np.diff(wv)) > PPR_TOL
            clear = np.r_[gaps, True] & np.r_[True, gaps]
            ok = np.allclose(sc, wv, rtol=PPR_TOL, atol=PPR_TOL) and \
                np.array_equal(ids[clear], wi[clear])
        else:
            lo, hi = int(indptr[q.vertex]), int(indptr[q.vertex + 1])
            ok = a.shape == (1,) and (
                int(a[0]) == q.vertex if hi == lo
                else bool((indices[lo:hi] == int(a[0])).any()))
        if not ok:
            bad.setdefault(kind, []).append(q)
    log(f"[check] service answers vs phase 4: reachability == msbfs level "
        f">= 0, distance bit-equal to plain sssp_batched, PPR within "
        f"{PPR_TOL} of ppr_topk (max score diff {worst!r}), samples real "
        f"out-neighbours; wrong: {bad or 'none'}")
    if bad:
        fail(f"service answers disagree with phase 4: {bad}")

    os.makedirs(os.path.dirname(SERVICE_TRACE), exist_ok=True)
    doc = obs.export_chrome_trace(SERVICE_TRACE)
    errors = validate_chrome_trace(doc)
    log(f"[check] service trace {os.path.relpath(SERVICE_TRACE, ROOT)}: "
        f"{len(doc['traceEvents'])} events, {len(obs.level_runs)} level "
        f"runs, structural errors {errors or 'none'}")
    if errors:
        fail(f"service trace is not structurally valid: {errors[:3]}")
    for line in format_summary(summarize(doc)).splitlines():
        log(f"[service] trace: {line}")

    # an update confined to the last partition
    last = svc.handle.n_partitions - 1
    lo = last * svc.handle.per_partition
    urng = np.random.default_rng(2)
    ins = (urng.integers(lo, n, SERVICE_INSERTS),
           urng.integers(lo, n, SERVICE_INSERTS),
           urng.random(SERVICE_INSERTS).astype(np.float32))
    cached = len(svc._cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = svc.apply_updates(inserts=ins)
    torch.cuda.synchronize()
    upd_s = time.perf_counter() - t0
    # the update re-derives delta from the new graph's weight histogram
    delta_s = host_s(lambda: auto_delta(svc.csr))
    log(f"[service] apply_updates({SERVICE_INSERTS} inserts in partition "
        f"{last}) in {upd_s!r} s (auto_delta alone {delta_s!r} s): "
        f"{rep.n_inserted} new, {rep.n_upserted} "
        f"upserted, partitions {rep.touched_partitions.tolist()}, epoch "
        f"{svc.epoch}, nnz {svc.csr.nnz}; evicted "
        f"{svc.stats.cache_evicted} of {cached} cache entries")
    if rep.touched_partitions.tolist() != [last] or \
            svc.csr.nnz != g.nnz + rep.n_inserted:
        fail("apply_updates: wrong partitions or edge count")
    samples = [(q, a) for q, a in zip(stream, answers)
               if isinstance(q, NeighborSample)]
    outside = [(q, a) for q, a in samples
               if int(svc.handle.partition_of(q.vertex)) != last]
    h0, b0 = svc.stats.cache_hits, svc.stats.batches
    kept, _ = serve([q for q, _ in outside])
    log(f"[check] service: {len(outside)} of {len(samples)} samples lie "
        f"outside partition {last}; re-asked: "
        f"{svc.stats.cache_hits - h0} cache hits, "
        f"{svc.stats.batches - b0} batches")
    if svc.stats.cache_hits - h0 != len(outside) or \
            svc.stats.batches != b0 or \
            not all(np.array_equal(k, a) for k, (_, a) in zip(kept, outside)):
        fail("service: samples outside the mutated partition did not survive")
    q = next(q for q in stream if isinstance(q, Distance))
    b0 = svc.stats.batches
    (got,), redo_s = serve([q])
    fresh = sssp_batched(svc.csr, [q.source], delta=svc.delta)
    want = fresh[0, q.target].cpu().numpy()
    log(f"[check] service: re-asked {q} after the update: {got!r} in "
        f"{redo_s!r} s ({svc.stats.batches - b0} batch); fresh "
        f"sssp_batched on the new graph {float(want)!r} (delta "
        f"{svc.delta!r})")
    if np.float32(got).tobytes() != want.tobytes():
        fail("service: a re-asked Distance differs from a fresh "
             "sssp_batched on the updated graph")

    st = svc.stats.as_dict()
    log(f"[service] stats: qps {st['qps']!r}, p50 {st['latency_p50_ms']!r} "
        f"ms, p95 {st['latency_p95_ms']!r} ms, occupancy "
        f"{st['occupancy']!r}, hit rate {st['hit_rate']!r}, route bytes per "
        f"query {st['route_bytes_per_query']!r}; {json.dumps(st)}")
    return {"queries": len(stream), "build_s": build_s, "flush_s": wall1,
            "cached_flush_s": wall2, "engine_s": batch_s,
            "readback_s": readback_s,
            "apply_updates_s": upd_s, "auto_delta_s": delta_s,
            "redo_distance_s": redo_s,
            "stats": st, "trace": os.path.relpath(SERVICE_TRACE, ROOT)}


def pooled_chisquare(counts, expected):
    """Chi-square (statistic, p) with the bins expected below 5 pooled into
    one (the test's approximation needs about 5 a bin)."""
    import numpy as np
    import scipy.stats
    low = expected < 5
    if low.any():
        counts = np.r_[counts[~low], counts[low].sum()]
        expected = np.r_[expected[~low], expected[low].sum()]
    return scipy.stats.chisquare(counts, expected)


def structured_phase(g, lv_p, d_p, cc_labels, delta, counted, err,
                     args) -> dict:
    """The structured phase on phase 4's graph: LPA and multi-level Louvain
    (reproducible, and equal to the CPU path at SMALL_SCALE), the
    segment_mode kernel's two entry points alone against their plain
    versions, walks and sampling held to the graph's edges and to their
    distributions, and repair after REPAIR_INSERTS inserts held to fresh
    runs.  Every path runs with the launch counts zeroed just before it and
    read just after.  Returns segment_mode's row of the kernels line (its
    launches those of the phase's paths) and the phase's numbers."""
    import numpy as np
    import torch
    from repro_torch.core import GraphHandle, csr_from_numpy, engine, \
        offload, rmat
    from repro_torch.core.algorithms import (
        bfs, connected_components, label_propagation, louvain, modularity,
        multilevel, neighbor_sample, random_walks, repair_or_recompute,
        sssp, ties_sample)
    from repro_torch.core.graph import _edge_keys, contract
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_mode as SM
    from repro_torch.obs import get_registry

    n, m, dev = g.n_rows, g.nnz, g.device
    out, launched = {}, {}

    def run(label, fn):
        """fn() with every count zeroed just before and read just after;
        returns (its result, host seconds up to the end of its work)."""
        for mod in counted:
            mod.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for mod in counted for k, v in mod.LAUNCHES.items()}
        for k, v in got.items():
            launched[k] = launched.get(k, 0) + v
        log(f"[structured] {label}: {wall!r} s; launches "
            f"{ {k: v for k, v in got.items() if v} }")
        return res, wall

    edge_keys = _edge_keys(g)
    deg = g.degrees().long()

    def bad_steps(frm, to):
        """How many (frm, to) pairs are neither an edge of g nor a sink
        staying put (counted on the card against the CSR's sorted keys)."""
        frm, to = frm.reshape(-1).long(), to.reshape(-1).long()
        q = frm * n + to
        pos = torch.searchsorted(edge_keys, q).clamp(max=m - 1)
        ok = (edge_keys[pos] == q) | ((deg[frm] == 0) & (frm == to))
        return (~ok).sum()

    # -- LPA: twice on RMAT-20, then RMAT-16 on the card and the CPU -------
    lpa, lpa_s = run(f"label_propagation(iters={LPA_ITERS})",
                     lambda: label_propagation(g, iters=LPA_ITERS))
    per_sweep = launched.get("segment_mode", 0) / LPA_ITERS
    lpa2, lpa2_s = run("label_propagation again",
                       lambda: label_propagation(g, iters=LPA_ITERS))
    n_lab = int(torch.unique(lpa).numel())
    log(f"[check] lpa: two runs bit-equal {torch.equal(lpa, lpa2)}; "
        f"{n_lab} labels; segment_mode launches per sweep {per_sweep!r}")
    if not torch.equal(lpa, lpa2):
        fail("label_propagation: two runs on the card differ")
    g16 = rmat(SMALL_SCALE, 16, seed=7, device=dev)
    c16 = csr_from_numpy(g16.indptr.cpu().numpy(), g16.indices.cpu().numpy(),
                         g16.values.cpu().numpy(), g16.n_rows, g16.n_cols,
                         device="cpu")
    l16, _ = run(f"label_propagation rmat-{SMALL_SCALE}",
                 lambda: label_propagation(g16, iters=LPA_ITERS))
    t0 = time.perf_counter()
    l16c = label_propagation(c16, iters=LPA_ITERS)
    cpu_lpa_s = time.perf_counter() - t0
    log(f"[check] lpa rmat-{SMALL_SCALE}: card bit-equal to the CPU path "
        f"{torch.equal(l16.cpu(), l16c)} (CPU {cpu_lpa_s!r} s)")
    if not torch.equal(l16.cpu(), l16c):
        fail(f"label_propagation at rmat-{SMALL_SCALE}: card != CPU path")

    # -- segment_mode alone on the LPA dense step's stream (final labels) --
    t_g = g.transpose()
    rows_t, cols_t = t_g.index64()
    key, order = torch.sort((cols_t << 32) | lpa[rows_t].long(), stable=True)
    dst, lab, sw = key >> 32, key & 0xFFFFFFFF, t_g.values[order]
    del key, order, rows_t, cols_t
    start, run_id = offload.run_starts(dst, lab)
    longest = int(torch.bincount(run_id).max())
    got = SM.segment_mode_kernel_call(dst, lab, sw, n)
    want = ref.segment_mode_ref(dst, lab, sw, n)
    torch.cuda.synchronize()
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    fin = torch.isfinite(want[0])
    err["segment_mode"] = float((got[0][fin] - want[0][fin]).abs().max())
    log(f"[parity] segment_mode ({dst.numel()} items, {n} destinations, "
        f"longest (destination, label) run {longest}): bit-equal {same}")
    if not same:
        fail("segment_mode: kernel disagrees with the plain version")
    mode_case = dict(
        case="segment_mode on the LPA dense step's stream",
        items=dst.numel(), longest_run=longest,
        ms=cuda_ms(lambda: SM.segment_mode_kernel_call(dst, lab, sw, n),
                   args.reps),
        plain_ms=cuda_ms(lambda: ref.segment_mode_ref(dst, lab, sw, n), 1, 1),
        # destination, label and weight read once, (best_w, label) written
        bound_ms=1e3 * (12 * dst.numel() + 8 * n) / HBM_BYTES_PER_S,
        bound_by="bytes", library_ms=None)
    log(f"[time] segment_mode: kernel {mode_case['ms']!r} ms, plain "
        f"{mode_case['plain_ms']!r} ms, bound {mode_case['bound_ms']!r} ms, "
        f"library none")
    del t_g, dst, lab, sw, start, run_id, got, want, fin

    # -- multilevel twice through the entry point, the first with its
    # -- module's sweep, local-move and contraction steps counted per level
    levels = []
    steps = {k: getattr(louvain, k) for k in ("_sweep", "louvain_local_moves",
                                              "contract")}

    def counting_sweep(*a, **k):
        levels[-1]["sweeps"] += 1
        return steps["_sweep"](*a, **k)

    def timed_moves(gl, **k):
        levels.append(dict(level=len(levels), n=gl.n_rows, m=gl.nnz,
                           sweeps=0))
        t0 = time.perf_counter()
        res = steps["louvain_local_moves"](gl, **k)
        torch.cuda.synchronize()
        levels[-1]["wall_s"] = time.perf_counter() - t0
        return res

    def sized_contract(gl, assign):
        coarse, renumber = steps["contract"](gl, assign)
        levels[-1].update(coarse_n=coarse.n_rows, coarse_m=coarse.nnz)
        return coarse, renumber

    for k, fn in (("_sweep", counting_sweep),
                  ("louvain_local_moves", timed_moves),
                  ("contract", sized_contract)):
        setattr(louvain, k, fn)
    try:
        (ml, scores), ml_s = run("multilevel (counted per level)",
                                 lambda: multilevel(g))
    finally:
        for k, fn in steps.items():
            setattr(louvain, k, fn)
    ml_launches = {k: launched.get(k, 0) for k in ("segment_mode",
                                                   "run_sum")}
    for i, lv in enumerate(levels):
        lv["accepted"] = i < len(scores)
        lv["q"] = scores[i] if i < len(scores) else None
        log(f"[structured] multilevel level {i}: {lv}")
    (ml2, scores2), ml2_s = run("multilevel", lambda: multilevel(g))
    q_check = float(modularity(g, ml))
    coarse, _ = contract(g, ml)
    q_coarse = float(modularity(coarse, torch.arange(
        coarse.n_rows, dtype=torch.int32, device=dev)))
    q_single = float(modularity(g, label_propagation(g, iters=1)))
    log(f"[check] multilevel: scores {scores}; two runs equal labels and "
        f"scores {torch.equal(ml, ml2) and scores == scores2}; "
        f"modularity(labels) {q_check!r}; contracted graph's Q {q_coarse!r}; "
        f"a single LPA sweep's Q {q_single!r}; {coarse.n_rows} communities")
    if not scores or not all(b > a for a, b in zip(scores, scores[1:])):
        fail("multilevel: the scores do not increase strictly")
    if not torch.equal(ml, ml2) or scores != scores2:
        fail("multilevel: two runs on the card differ")
    if abs(q_check - scores[-1]) > 1e-6 or abs(q_coarse - scores[-1]) > 1e-5:
        fail("multilevel: Q disagrees with modularity of its labels or of "
             "the contracted graph")
    if not scores[-1] > q_single:
        fail("multilevel: Q does not beat a single LPA sweep")
    (m16, s16), _ = run(f"multilevel rmat-{SMALL_SCALE}",
                        lambda: multilevel(g16))
    t0 = time.perf_counter()
    m16c, s16c = multilevel(c16)
    cpu_ml_s = time.perf_counter() - t0
    log(f"[check] multilevel rmat-{SMALL_SCALE}: card bit-equal to the CPU "
        f"path {torch.equal(m16.cpu(), m16c) and s16 == s16c} (scores "
        f"{s16}; CPU {cpu_ml_s!r} s)")
    if not torch.equal(m16.cpu(), m16c) or s16 != s16c:
        fail(f"multilevel at rmat-{SMALL_SCALE}: card != CPU path")
    del g16, c16, l16, l16c, m16, m16c, ml2

    # -- run_sum alone on contract's stream (the final labels) -------------
    rows, cols = g.index64()
    dense, _ = offload.compact_labels(ml)
    key, order = torch.sort((dense[rows].long() << 32) | dense[cols].long(),
                            stable=True)
    _, run_id = offload.run_starts(key)
    n_runs = int(run_id[-1]) + 1
    sv = g.values[order]
    longest = int(torch.bincount(run_id).max())
    del key, order, dense
    got = SM.run_sum_kernel_call(run_id, sv, n_runs)
    want = ref.run_sum_ref(run_id, sv, n_runs)
    torch.cuda.synchronize()
    log(f"[parity] run_sum ({m} items, {n_runs} runs, longest {longest}): "
        f"bit-equal {torch.equal(got, want)}")
    if not torch.equal(got, want):
        fail("run_sum: kernel disagrees with the plain in-order sum")
    err["segment_mode"] = max(err["segment_mode"],
                              float((got - want).abs().max()))
    sum_case = dict(
        case="run_sum on contract's stream", items=m, runs=n_runs,
        longest_run=longest,
        ms=cuda_ms(lambda: SM.run_sum_kernel_call(run_id, sv, n_runs),
                   args.reps),
        plain_ms=cuda_ms(lambda: ref.run_sum_ref(run_id, sv, n_runs), 1, 1),
        # ids and weights read once, the run sums written once
        bound_ms=1e3 * (8 * m + 4 * n_runs) / HBM_BYTES_PER_S,
        bound_by="bytes", library_ms=None)
    log(f"[time] run_sum: kernel {sum_case['ms']!r} ms, plain "
        f"{sum_case['plain_ms']!r} ms, bound {sum_case['bound_ms']!r} ms, "
        f"library none")
    del run_id, sv, got, want

    # -- walks and sampling ------------------------------------------------
    walks, walk_s = run(f"random_walks ({n} walkers x {WALK_STEPS} steps)",
                        lambda: random_walks(g, torch.arange(n, device=dev),
                                             WALK_STEPS, key=41))
    bad = sum(bad_steps(walks[:, t], walks[:, t + 1])
              for t in range(WALK_STEPS))
    log(f"[check] random_walks {tuple(walks.shape)}: steps that are neither "
        f"an out-edge nor a sink staying put: {int(bad)}")
    if int(bad) or walks.shape != (n, WALK_STEPS + 1):
        fail("random_walks: a step leaves the graph's edges")
    del walks
    hub = int(torch.argmax(deg))
    lo, hi = int(g.indptr[hub]), int(g.indptr[hub + 1])
    hub_cols = g.indices[lo:hi]
    chi = {}
    for weighted in (False, True):
        kind = "weighted" if weighted else "unweighted"
        keys = engine.fold_in(engine.as_key(43 + weighted, dev),
                              torch.arange(SAMPLE_DRAWS, device=dev))
        picks, s = run(f"sample_neighbors {kind} x {SAMPLE_DRAWS} at hub "
                       f"{hub} (degree {hi - lo})",
                       lambda: engine.sample_neighbors(
                           g, torch.full((SAMPLE_DRAWS,), hub, device=dev),
                           keys,
                           weighted=weighted))
        pos = torch.searchsorted(hub_cols, picks).clamp(max=hi - lo - 1)
        if not bool((hub_cols[pos] == picks).all()):
            fail(f"sample_neighbors {kind}: a pick is not a hub out-edge")
        counts = torch.bincount(pos, minlength=hi - lo).cpu().numpy()
        w = g.values[lo:hi].double().cpu().numpy() if weighted else \
            np.ones(hi - lo)
        stat, p = pooled_chisquare(counts, SAMPLE_DRAWS * w / w.sum())
        chi[kind] = dict(s=s, stat=float(stat), p=float(p))
        log(f"[check] sample_neighbors {kind}: chi-square {float(stat)!r}, p "
            f"{float(p)!r} "
            f"(must exceed 1e-4)")
        if not p > 1e-4:
            fail(f"sample_neighbors {kind}: chi-square p {p} <= 1e-4")
    seeds = torch.from_numpy(np.random.default_rng(5).choice(
        n, SAGE_SEEDS, replace=False)).to(dev)
    layers, sage_s = run(f"neighbor_sample {SAGE_FANOUTS} x {SAGE_SEEDS}",
                         lambda: neighbor_sample(g, seeds, SAGE_FANOUTS,
                                                 key=44))
    f1, f2 = SAGE_FANOUTS
    shapes = [tuple(x.shape) for x in layers]
    bad = int(bad_steps(layers[0].repeat_interleave(f1), layers[1])
              + bad_steps(layers[1].reshape(-1).repeat_interleave(f2),
                          layers[2]))
    log(f"[check] neighbor_sample: shapes {shapes}, invalid picks {bad}")
    if shapes != [(SAGE_SEEDS,), (SAGE_SEEDS, f1), (SAGE_SEEDS, f1, f2)] \
            or bad:
        fail("neighbor_sample: wrong shapes or invalid picks")
    n_e = m // 100
    (node_set, n_nodes, mask), ties_s = run(
        f"ties_sample ({n_e} edges)",
        lambda: ties_sample(g, n_e, 2 * n_e, key=45))
    k = int(n_nodes)
    nodes = node_set[:k]
    rows32 = g.row_ids()
    induced = torch.isin(rows32, nodes) & torch.isin(g.indices, nodes)
    ends = torch.cat([rows32[mask], g.indices[mask]])
    ok = (bool((nodes[1:] > nodes[:-1]).all())
          and bool((node_set[k:] == -1).all()) and torch.equal(mask, induced)
          and bool(torch.isin(nodes, ends).all()))
    log(f"[check] ties_sample: {k} nodes, {int(mask.sum())} induced edges; "
        f"sorted, unique, mask == induced edges, every node an endpoint "
        f"{ok}")
    if not ok:
        fail("ties_sample: its invariants do not hold")
    del node_set, mask, induced, ends, rows32

    # -- repair after REPAIR_INSERTS inserts, then a batch with deletes ----
    rng = np.random.default_rng(3)
    handle = GraphHandle.wrap(g)
    handle, rep = handle.apply((rng.integers(0, n, REPAIR_INSERTS),
                                rng.integers(0, n, REPAIR_INSERTS),
                                rng.random(REPAIR_INSERTS).astype(np.float32)))
    if not rep.monotone_safe:
        fail("the insert batch is not monotone-safe")
    csr = handle.csr
    prev = {"bfs": lv_p, "cc": cc_labels, "sssp": d_p}
    fresh = {"bfs": lambda: bfs(csr, 0),
             "cc": lambda: connected_components(csr),
             "sssp": lambda: sssp(csr, 0, delta=delta)}
    repair = {}
    for kind in ("bfs", "sssp", "cc"):
        got, s = run(f"repair {kind}", lambda: repair_or_recompute(
            kind, handle, prev[kind], rep, source=0))
        want, s_fresh = run(f"recompute {kind}", fresh[kind])
        repair[kind] = dict(repair_s=s, recompute_s=s_fresh)
        log(f"[check] repair {kind} after {rep.n_inserted} inserts "
            f"({rep.n_upserted} upserts): bit-equal to a fresh run "
            f"{torch.equal(got, want)}; repair {s!r} s, recompute "
            f"{s_fresh!r} s")
        if not torch.equal(got, want):
            fail(f"repair {kind} differs from a fresh run")
        prev[kind] = got
    ctr = get_registry().counter("streaming.full_recompute_fallback")
    c0 = ctr.value
    pick = torch.arange(0, m, m // 16, device=dev)[:16]
    handle, rep = handle.apply(deletes=(
        g.row_ids()[pick].cpu().numpy(), g.indices[pick].cpu().numpy()))
    for kind in ("bfs", "sssp", "cc"):
        run(f"fallback {kind}", lambda: repair_or_recompute(
            kind, handle, prev[kind], rep, source=0))
    log(f"[check] a batch of {rep.n_deleted} deletes: monotone-safe "
        f"{rep.monotone_safe}; streaming.full_recompute_fallback rose by "
        f"{ctr.value - c0}")
    if rep.monotone_safe or ctr.value - c0 != 3:
        fail("the delete batch did not take the counted fallback")
    for k in ("segment_mode", "run_sum"):
        if not launched.get(k):
            fail(f"the structured phase did not launch {k}")
    row = dict(
        launches=launched["segment_mode"] + launched["run_sum"],
        entry_launches={k: launched[k] for k in ("segment_mode", "run_sum")},
        **{key: mode_case[key] for key in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")},
        cases=[mode_case, sum_case])
    out.update(lpa_s=[lpa_s, lpa2_s], lpa_cpu_rmat16_s=cpu_lpa_s,
               lpa_labels=n_lab, segment_mode_per_lpa_sweep=per_sweep,
               multilevel_s=[ml_s, ml2_s], multilevel_levels=levels,
               multilevel_launches=ml_launches,
               multilevel_cpu_rmat16_s=cpu_ml_s, q_single_sweep=q_single,
               walks_s=walk_s, sample=chi, neighbor_sample_s=sage_s,
               ties_s=ties_s, repair=repair)
    return row, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "chip_smoke.json"),
                    help="where to write the run's numbers as JSON")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a card")
    from repro_torch.core import engine, rmat
    from repro_torch.core.algorithms import (bfs, connected_components,
                                             pagerank, spmv, spmv_bbcsr, sssp,
                                             sssp_program, auto_delta)
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import segment_mode as SM
    from repro_torch.obs import get_registry
    from repro_torch.kernels import segment_or as SO
    from repro_torch.kernels import spmv_dma as K

    t_all = time.perf_counter()
    # -- 1. device -----------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} sm_{cap[0]}{cap[1]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")

    # -- 2. build: one nvcc per source, all started together -----------------
    t0 = time.perf_counter()
    built = _build.compile_all()
    log(f"[build] {len(built)} sources in {time.perf_counter() - t0:.2f} s")
    for lib_path, ptxas in built.values():
        log(f"[build] {lib_path.name}")
        for line in ptxas.splitlines():
            if "registers" in line or "Compiling entry" in line or \
                    "spill" in line:
                log(f"[build]   {line.strip()}")

    # -- tune ----------------------------------------------------------------
    tuned = tune_phase(args)

    # -- graph ---------------------------------------------------------------
    t0 = time.perf_counter()
    g = rmat(args.scale, 16, seed=7)
    torch.cuda.synchronize()
    n = g.n_rows
    log(f"[graph] rmat({args.scale}, 16, seed=7): n={n} nnz={g.nnz} "
        f"in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand(n, device="cuda", generator=gen)
    fallback = get_registry().counter("tune.autotune_fallback")
    fallbacks0 = fallback.value
    tuned["geometry"] = tuned_geometry(g, x)
    t0 = time.perf_counter()
    bb = engine.build_pull_operand(g)
    torch.cuda.synchronize()
    real = int(bb.tile_cnt.long().sum())
    log(f"[graph] pull operand {bb.block_rows}/{bb.block_cols}/{bb.tile_nnz}:"
        f" {bb.n_tiles} tiles, {real} real slots "
        f"({bb.n_tiles * bb.tile_nnz / max(real, 1):.1f} slots per nonzero) "
        f"in {time.perf_counter() - t0:.2f} s")

    rb_slots = torch.zeros(bb.n_row_blocks, dtype=torch.int64, device="cuda")
    rb_slots.index_add_(0, bb.tile_rb.long(), bb.tile_cnt.long())
    rb_tiles = (bb.rb_ptr[1:] - bb.rb_ptr[:-1]).long()
    log(f"[graph] per row block: real slots max {int(rb_slots.max())} mean "
        f"{float(rb_slots.double().mean())!r}; tiles max "
        f"{int(rb_tiles.max())} mean {float(rb_tiles.double().mean())!r}")

    # B2/B3 sparse frontier: 8 vertices in each of ~1% of the column blocks
    n_cb = bb.n_col_blocks
    blocks = torch.randperm(n_cb, device="cuda", generator=gen)[
        :max(1, n_cb // 100)]
    offs = torch.randint(0, bb.block_cols, (blocks.numel(), 8), device="cuda",
                         generator=gen)
    ids = (blocks[:, None] * bb.block_cols + offs).reshape(-1)
    ids = ids[ids < n]
    frontier = torch.zeros(n, dtype=torch.int32, device="cuda")
    frontier[ids] = 1
    act = engine.tile_active(bb, frontier)
    all_act = torch.ones(bb.n_tiles, dtype=torch.int32, device="cuda")
    x_sp = torch.where(frontier > 0, x, 0.0)
    x_min = torch.where(frontier > 0, x, float("inf"))
    x_max = torch.where(frontier > 0, x, float("-inf"))
    log(f"[graph] sparse frontier: {ids.numel()} vertices, "
        f"{int((act != 0).sum())}/{bb.n_tiles} tiles active")

    # -- 3. kernel parity ----------------------------------------------------
    err = {}

    def check(entry, label, got, want, exact):
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        fin = torch.isfinite(want)
        if not torch.equal(torch.isfinite(got), fin) or \
                not torch.equal(got[~fin], want[~fin]):
            fail(f"{label}: non-finite entries differ")
        d = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
        if exact:
            ok = torch.equal(got, want)
        else:
            ok = bool(torch.allclose(got, want, rtol=ADD_RTOL, atol=ADD_ATOL))
        log(f"[parity] {label}: max |kernel - plain| = {d!r} "
            f"({'exact' if exact else f'rtol {ADD_RTOL} atol {ADD_ATOL}'})")
        if not ok:
            fail(f"{label}: kernel disagrees with the plain version")
        err[entry] = max(err.get(entry, 0.0), d)

    K.reset_launches()
    check("spmv_bbcsr", "B1 spmv add", K.spmv_bbcsr_kernel_call(bb, x),
          ref.spmv_bbcsr_ref(bb, x), False)
    check("spmspv_bbcsr_add", "B2 spmspv add 1% blocks",
          K.spmspv_bbcsr_kernel_call(bb, x_sp, act),
          ref.spmspv_bbcsr_ref(bb, x_sp, act), False)
    for comb, xs in (("min", x_min), ("max", x_max)):
        check("spmspv_bbcsr_select", f"B3 spmspv {comb} all-active",
              K.spmspv_bbcsr_kernel_call(bb, x, all_act, combine=comb),
              ref.spmspv_bbcsr_ref(bb, x, all_act, combine=comb), True)
        check("spmspv_bbcsr_select", f"B3 spmspv {comb} sparse",
              K.spmspv_bbcsr_kernel_call(bb, xs, act, combine=comb),
              ref.spmspv_bbcsr_ref(bb, xs, act, combine=comb), True)

    # the 'add' kernels sum in a fixed order: two launches, equal bits
    for label, fn in (
            ("B1 spmv", lambda: K.spmv_bbcsr_kernel_call(bb, x)),
            ("B2 spmspv add", lambda: K.spmspv_bbcsr_kernel_call(
                bb, x_sp, act))):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        same = torch.equal(first, second)
        log(f"[repro] {label}: two launches bit-equal: {same}")
        if not same:
            fail(f"{label}: two launches on the same inputs differ")
        del first, second

    # -- 5. timings (on the weighted operand, before it is freed) -------------
    t_a = g.transpose()
    lib_mat = torch.sparse_csr_tensor(t_a.indptr, t_a.indices, t_a.values,
                                      size=(n, n))
    timed = {
        "spmv_bbcsr": dict(
            ms=cuda_ms(lambda: K.spmv_bbcsr_kernel_call(bb, x), args.reps),
            plain_ms=cuda_ms(lambda: ref.spmv_bbcsr_ref(bb, x), 3, 1),
            bound_ms=bound_ms(bb),
            library_ms=cuda_ms(lambda: torch.mv(lib_mat, x), args.reps)),
        "spmspv_bbcsr_add": dict(
            ms=cuda_ms(lambda: K.spmspv_bbcsr_kernel_call(bb, x_sp, act),
                       args.reps),
            plain_ms=cuda_ms(lambda: ref.spmspv_bbcsr_ref(bb, x_sp, act), 3,
                             1),
            bound_ms=bound_ms(bb, act),
            # x_sp is zero off the frontier, so A @ x_sp is the same function
            library_ms=cuda_ms(lambda: torch.mv(lib_mat, x_sp), args.reps)),
        "spmspv_bbcsr_select": dict(
            ms=cuda_ms(lambda: K.spmspv_bbcsr_kernel_call(
                bb, x, all_act, combine="min"), args.reps),
            plain_ms=cuda_ms(lambda: ref.spmspv_bbcsr_ref(
                bb, x, all_act, combine="min"), 3, 1),
            bound_ms=bound_ms(bb, all_act),
            library_ms=None),
    }
    sparse_min_ms = cuda_ms(lambda: K.spmspv_bbcsr_kernel_call(
        bb, x_min, act, combine="min"), args.reps)
    for entry, t in timed.items():
        log(f"[time] {entry}: kernel {t['ms']!r} ms, plain {t['plain_ms']!r} "
            f"ms, bound {t['bound_ms']!r} ms, library {t['library_ms']!r} ms")
    log(f"[time] spmspv_bbcsr_select min sparse: kernel {sparse_min_ms!r} ms,"
        f" bound {bound_ms(bb, act)!r} ms")
    heavy = heaviest_block_diagnostic(bb, rb_slots, x, all_act, args.reps)
    del lib_mat

    # -- 4. main path ----------------------------------------------------------
    counted = (K, SO, SM)
    launches = {k: 0 for mod in counted for k in mod.LAUNCHES}
    walls, path_launches = {}, {}

    def path(label, fn):
        """Run one query with the launch counts zeroed before it and read
        after it, then once more for a warm wall time (not counted)."""
        for mod in counted:
            mod.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        path_launches[label] = {k: v for mod in counted
                                for k, v in mod.LAUNCHES.items()}
        for k, v in path_launches[label].items():
            launches[k] += v
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[label] = (cold, time.perf_counter() - t0)
        log(f"[path] {label}: {cold!r} s cold, {walls[label][1]!r} s warm; "
            f"launches {path_launches[label]}")
        return out

    torch.cuda.reset_peak_memory_stats()
    y_k = path("spmv_bbcsr", lambda: spmv_bbcsr(bb, x))
    # the pull operand holds A^T: the plain SpMV runs on the same matrix
    y_p = path("spmv (plain)", lambda: spmv(t_a, x))
    if not torch.allclose(y_k, y_p, rtol=1e-4, atol=1e-4):
        fail("spmv_bbcsr disagrees with spmv beyond rtol/atol 1e-4")
    log(f"[check] spmv_bbcsr vs spmv: max diff "
        f"{float((y_k - y_p).abs().max())!r} (rtol/atol 1e-4)")
    del bb, t_a, y_k, y_p
    torch.cuda.empty_cache()

    bb_u = engine.build_pull_operand(g, unit_values=True)
    lv_k = path("bfs kernel_bb", lambda: bfs(g, 0, kernel_bb=bb_u))
    lv_p = path("bfs (plain)", lambda: bfs(g, 0))
    if not torch.equal(lv_k, lv_p):
        fail("BFS levels differ between the kernel path and the plain path")
    bfs_reached = int((lv_p >= 0).sum())
    # on the kernel path a pull level is one SpMV launch, a push level one
    # SpMSpV launch
    log(f"[check] bfs levels bit-equal; reached {bfs_reached}, depth "
        f"{int(lv_p.max())}; kernel path pulls "
        f"{path_launches['bfs kernel_bb']['spmv_bbcsr']} pushes "
        f"{path_launches['bfs kernel_bb']['spmspv_bbcsr_add']}")
    # one warm run is noisy: BFS's kernel path over BFS_RUNS more, and the
    # unit-value check of its operand, which every run paid before the
    # answer was kept per operand
    bfs_walls = sorted(host_s(lambda: bfs(g, 0, kernel_bb=bb_u))
                       for _ in range(BFS_RUNS))
    check_ms = cuda_ms(lambda: engine._unit_valued(bb_u.vals), 5, 1)
    log(f"[time] bfs kernel path warm over {BFS_RUNS} runs: median "
        f"{statistics.median(bfs_walls)!r} s, min {bfs_walls[0]!r} s, max "
        f"{bfs_walls[-1]!r} s; the operand's unit-value check {check_ms!r} "
        f"ms (now read once per operand)")
    # the batched lanes: vertex 0, then 31 vertices with out-edges
    deg = g.degrees().cpu().numpy()
    sources = np.concatenate([[0], np.random.default_rng(0).choice(
        np.flatnonzero(deg >= 1), LANES - 1, replace=False)]).astype(np.int32)
    log(f"[batched] {LANES} sources: {sources.tolist()}")
    top_v, top_i = batched_ppr(g, bb_u, sources, path, path_launches)
    so_row, lv_b = batched_msbfs(g, sources, lv_p, path, path_launches, err,
                                 args)
    log(f"[mem] peak allocated with the unit operand "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del bb_u
    torch.cuda.empty_cache()

    delta = auto_delta(g)
    bb_m = engine.build_pull_operand(g, combine="min")

    def sssp_kernel():
        dist0 = torch.full((n,), float("inf"), device="cuda")
        dist0[0] = 0.0
        pend0 = torch.zeros(n, dtype=torch.bool, device="cuda")
        pend0[0] = True
        f0 = torch.zeros(n, dtype=torch.int32, device="cuda")
        f0[0] = 1
        state0 = {"dist": dist0, "pending": pend0,
                  "bound": torch.tensor(delta, device="cuda")}
        return engine.run(g, sssp_program(delta), state0, f0,
                          max_iters=4 * n, kernel_bb=bb_m, return_stats=True)

    st_k, stats_k = path("sssp kernel_bb", sssp_kernel)
    d_b = batched_sssp(g, bb_m, sources, delta, path, path_launches)
    log(f"[mem] peak allocated with the (min,+) operand "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del bb_m
    torch.cuda.empty_cache()

    # the service, on phase 4's graph and sources, held to its results
    for mod in counted:
        mod.reset_launches()
    t0 = time.perf_counter()
    service = service_phase(g, sources, lv_b, d_b, (top_v, top_i), delta,
                            args)
    service["phase_s"] = time.perf_counter() - t0
    log(f"[service] phase wall {service['phase_s']!r} s")
    path_launches["service"] = {k: v for mod in counted
                                for k, v in mod.LAUNCHES.items()}
    for k, v in path_launches["service"].items():
        launches[k] += v
    log(f"[service] launches {path_launches['service']}")
    if path_launches["service"]["segment_or"] == 0:
        fail("the service's Reachability batch did not launch segment_or")
    del lv_b, d_b, top_v, top_i
    d_p, stats_p = path("sssp (plain)",
                        lambda: sssp(g, 0, delta=delta, return_stats=True))
    if not torch.equal(st_k["dist"], d_p):
        fail("SSSP distances differ between the kernel path and the plain "
             "path")
    sssp_reached = int(torch.isfinite(d_p).sum())
    log(f"[check] sssp distances bit-equal (delta {delta!r}); stats kernel "
        f"{stats_k} plain {stats_p}")
    log(f"[check] bfs reached == sssp reached: {bfs_reached} == "
        f"{sssp_reached}: {bfs_reached == sssp_reached}")
    if bfs_reached != sssp_reached:
        fail("BFS and SSSP reach different vertex sets")

    pr = path("pagerank", lambda: pagerank(g))
    mass = float(pr.double().sum())
    log(f"[check] pagerank mass {mass!r}")
    if not (torch.isfinite(pr).all() and abs(mass - 1.0) <= 1e-3):
        fail(f"pagerank mass {mass} is not 1 within 1e-3")

    labels, cc_stats = path("connected_components", lambda:
                            connected_components(g, return_stats=True))
    roots = labels[labels.long()]
    n_comp = int((labels == torch.arange(n, device="cuda")).sum())
    if not (torch.equal(roots, labels)
            and bool((labels <= torch.arange(n, device="cuda")).all())
            and bool((labels[lv_p >= 0] == labels[0]).all())):
        fail("connected-component labels are not min-member roots that "
             "cover the BFS tree of vertex 0")
    log(f"[check] cc: {n_comp} components, stats {cc_stats}")
    moved = fallback.value - fallbacks0
    log(f"[check] tune.autotune_fallback moved by {moved} over phases 3-4 "
        f"(the graph path, the batched lanes, the service, PageRank, CC)")
    if moved:
        fail("a tunable of the graph path fell back to its default: the "
             "committed tuned file was missing or misread")
    log(f"[mem] peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")

    # the structured phase, on the same graph, holding repair to phase 4's
    # BFS, SSSP and CC results
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sm_row, structured = structured_phase(g, lv_p, d_p, labels, delta,
                                          counted, err, args)
    structured["phase_s"] = time.perf_counter() - t0
    log(f"[structured] phase wall {structured['phase_s']!r} s")
    log(f"[mem] structured phase peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches["segment_mode"] = sm_row.pop("launches")
    timed["segment_mode"] = sm_row
    for k in ("spmv_bbcsr", "spmspv_bbcsr_add", "spmspv_bbcsr_select",
              "segment_or"):
        if launches[k] == 0:
            fail(f"kernel {k} was not launched on the main path")
    for k in ("spmv_bbcsr", "spmspv_bbcsr_add", "spmspv_bbcsr_select"):
        timed[k]["bound_by"] = "bytes"
    timed["segment_or"] = so_row

    # the graph path's operands are gone; phase 6 needs only the edge ids
    seg = g.transpose().row_ids()
    del g, labels, roots, pr, lv_k, lv_p, st_k, d_p, deg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops_rows = ops_phase(args, seg, n, err)
    log(f"[mem] phase 6 peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    timed.update(ops_rows)
    for k, t in ops_rows.items():
        launches[k] = t.pop("launches")

    kernels = [dict(name=k, route="cuda", source=SOURCE[k],
                    replaces=REPLACES[k], launches=launches[k],
                    max_abs_err=err[k], ms=timed[k]["ms"],
                    plain_ms=timed[k]["plain_ms"],
                    bound_ms=timed[k]["bound_ms"],
                    bound_by=timed[k]["bound_by"],
                    library_ms=timed[k]["library_ms"],
                    **{key: timed[k][key] for key in ("shape", "cases",
                                                      "entry_launches")
                       if key in timed[k]})
               for k in SOURCE]
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"device": name, "nvidia_smi": smi, "scale": args.scale,
                   "kernels": kernels, "walls_s": walls,
                   "service": service, "structured": structured,
                   "sparse_min_ms": sparse_min_ms, "heaviest_block": heavy,
                   "tune": tuned,
                   "total_s": time.perf_counter() - t_all}, fh, indent=1)
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
