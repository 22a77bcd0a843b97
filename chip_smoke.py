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
   then the distributed phase (``[dist]`` lines): the graph is sharded
   once on the host with the degree-balanced rule (its reverse by the same
   rule, the symmetrized graph by its own) and saved with the earlier
   phases' results under ``build/dist``; 4 ranks sharing the card over
   gloo (CUDA tensors) run ``bfs_distributed`` (auto, and async with
   sync_interval 4), ``sssp_distributed`` at phase 3's delta,
   ``connected_components_distributed``, ``pagerank_distributed`` (phase
   3's iterations), ``spmv_distributed`` in both modes,
   ``msbfs_distributed`` over phase 4's 32 sources,
   ``sssp_batched_distributed`` over the first 8 and
   ``label_propagation_distributed(iters=8)``, each with the mesh's
   collective counts and the kernels' launch counts zeroed just before it
   and read just after; BFS, SSSP, CC, every msbfs and sssp_batched lane
   and LPA must equal the local results bit for bit, PageRank (rtol 1e-4,
   atol 1e-9, mass 1 within 1e-3) and SpMV (rtol 1e-4, atol 1e-5) be
   close; ``segment_or`` and ``segment_mode`` must be launched; each
   level's collectives and routed bytes must equal ``core.traffic``'s
   model; then a 1-rank NCCL mesh runs the direction-optimizing BFS once
   more (bit-equal); each path logs the host seconds inside its
   collectives and the card seconds between CUDA events around them;
   then the second distributed phase (``[dist2]`` lines) on the same
   shards, 4 ranks sharing the card as a (2, 2) grid ('data', 'model'):
   ``queue_balance`` of a skewed queue (counts within 1, items kept),
   ``random_walks_distributed`` (one walker per vertex, 80 steps, on the
   queue engine; bit-equal to the structured phase's walks),
   ``multilevel_distributed`` (Q within 1e-5 of the structured phase's
   ``multilevel``; the share of labels that differ logged),
   ``update_shards`` after the structured phase's inserts (a padding
   overflow falls back on every rank) and ``bfs_repair_distributed`` /
   ``cc_repair_distributed`` (bit-equal to its repairs),
   ``GraphService(mesh=...)`` sync and async over phase 4's first 8
   sources, 4 targets each (Reachability and Distance equal to phase
   4's batched results) and a BFS over the grid's tuple axis (bit-equal)
   with ``hierarchical_psum`` over both axes; each path with its wall,
   collectives, bytes, host and card seconds and peak memory per rank;
   ``segment_mode`` and ``segment_or`` must be launched; the structured
   phase also prices ``run_sum``'s order floor (``[time] run_sum's
   order floor``: a chain of dependent f32 adds timed on the card);
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
   over the RMAT graph's in-edges (d 64, sorted ids: the kernel on its plan
   and the entry with the plan built inside), then ``segment_sum_csr`` (B4
   with the row gather fused in) on gin-tu's ogb_products edges as GIN's
   layer calls it, one ``gnn.EdgePlan`` for all three kinds: the forward at
   d 100 and d 64 and the backward at d 64, each beside both bounds (the
   gathered rows read once; the table read once), ``torch.sparse.mm`` on
   the same CSR of ones (cuSPARSE SpMM) and ``index_add_`` of the (E, d)
   messages the port no longer writes; each B4 case held also to its
   order's mirror bit for bit, run twice for equal bits and on a planted
   fault (its longest row's largest entry dropped), which must fail the
   check (``[repro]``); B4 timed at each block_n of ``B4_BLOCK_NS`` on
   RMAT-20 and on gin-tu's d 64 forward (the tuned default's choice);
   ``embedding_bag`` (B5) on fm
   serving (39 fields x 1M rows: ``serve_bulk`` batch 262,144 as a sum and
   as a weighted mean with 10% of ids -1, ``serve_p99`` batch 512 as a
   sum, each with the bytes of its rows' 32-byte sectors beside its byte
   bound, for information), ``flash_attention`` (B6)
   at qwen3-14b prefill 4096 and decode over 32768 keys at batch 128 and
   at batch 1 and at mixtral-8x7b's 4096-token window over 8192; each B6
   call must take the path the wrapper's dispatch rule gives it (the
   wgmma kernel for prefill and window, the folded kernel with its keys
   split for the batch-1 decode, unsplit at batch 128), read from the
   per-path launch counts, and its case names that path;
7. model serving (``[model]`` and ``[check] model`` lines): qwen3-14b at
   its published widths (14.77 B parameters, bf16) through
   ``repro_torch.launch.serve.serve_lm``, prefill 4 x 512 then 32 greedy
   decode steps, B6's counts zeroed just before and read just after (40
   wgmma calls on prefill, 40 a decode step); a warm rerun; decode held to
   ``forward`` and the kernel route to the plain route (B6's plain version
   patched in for ``ops.flash_attention``) on the logits, per row 5e-2,
   and every B6 call of prefill and 4 decode steps to its plain version as
   phase 6 holds it; B6's share of a decode step from CUDA events; peak
   memory; mixtral-8x7b's smoke config on the card against the CPU past
   its window (1e-4); fm at full width (``serve_p99``, ``serve_bulk``,
   ``retrieval_cand``) against a float64 plain gather (1e-5).  The B6
   entry's launches add the model path's, in a case of their own.  Then
   MLA serving: minicpm3-4b at its published widths through ``serve_lm``,
   prefill 1 x 32,768 through the online softmax
   (``transformer.online_attention``, once a layer, no B6) and 8 greedy
   steps, with the prefill wall, decode ms a step and the peak (under 80
   GB), the prefill's own peak kept for phase 11; a 4 x 512 prompt's
   logits on that route held to the plain route by the floor rule above
   (prefill and ``forward``);
8. training (``[train]`` and ``[check] train`` lines): one ``make_step``
   train step of each smoke config (qwen3, minicpm3, mixtral, the four
   GNNs, fm) on the card and on the CPU from the same parameters at lr
   1e-3 with no warmup (loss 1e-4 relative, every gradient finite, nonzero
   where the CPU's is and within 1e-4 of the largest, parameters after the
   step 1e-4 where the gradient's sign is decided); B6 launched no time
   in a train step and once a layer on prefill; gin-tu at its published
   widths on the ``ogb_products`` cell (``uniform_random_graph(2449029,
   25)``, padded to the cell's shape) for 4 steps on one batch, B4's
   launches counted per step (14), every B4 call of step 1 held to its
   plain version (1e-4),
   each kind of B4 call timed beside ``torch.sparse.mm``, a step profiled
   (its torch gathers must take less time than one (E, d) message takes to
   write: GIN gathers its rows inside B4); the
   four GNNs at their published widths on the ``molecule`` cell (a cold
   step, then a warm one); minicpm3-4b
   (4.26 B parameters) at ``train_4k``'s sequence, batch 2, 3 steps in
   bf16 and 3 with f32 weights (every parameter gets a finite nonzero
   gradient, step 1 changes at least half the weights, the loss of the f32
   run falls); an async checkpoint restored into a fresh state bit for bit
   and ``run_training`` through two injected failures, step for step equal
   to an uninterrupted run; the train CLI as a subprocess.  The B4
   entry's launches add the training path's, in a case of their own;
9. training over a process mesh (``[mesh]`` and ``[check] mesh`` lines):
   4 ranks sharing the card over gloo (a (4, 1) ('data', 'model') grid)
   train gin-tu at its published widths with its own DGAS threshold on
   ``uniform_random_graph(65536, 25, seed=0)`` for 2 steps, each rank
   reading its block of the batch alone (``gnn.local_batch``), each rank's
   step measured (wall around a barrier plus synchronize; calls, bytes,
   host and card seconds per collective kind; dropped requests; B4
   launches and device time; peak memory), held to the local step this
   process runs on the same graph, parameters and batch (loss 1e-5,
   gradients 1e-4 of the largest, parameters by phase 8's rule; 0 drops; B4
   on every rank, each of its calls held to its plain version at 1e-4);
   a sharded checkpoint after step 1 restored on 2 ranks
   and on 1, each step 2 held to the 4-rank one; the 4-rank steps run
   under run_training with a failure injected on every rank at step 2,
   step for step equal to the uninterrupted local steps;
   compression of step 1's gradients (bf16 within 1e-2 / 1e-3 of the f32
   sum, int8 within 0.05 / 1e-3 and the bits of the reference's
   arithmetic, bytes halved and quartered); fm at its published widths
   with ``fm_dgas``: serve_bulk scoring and a train_batch step held to
   the local ones (1e-5); the last gin-tu step's own peak kept for phase
   11; every collective of the phases with several ranks fails, named,
   past CHIP_COLL_TIMEOUT_S; the phase fails past 120 s.  The B4 entry's
   launches add the owners' sums, in a case of their own;
10. the LM over a process mesh (``[lmmesh]`` and ``[check] lmmesh``
   lines): 4 ranks sharing the card over gloo.  On a (2, 2) ('data',
   'model') grid: one train step of each smoke LM (qwen3, minicpm3,
   mixtral, llama4; qwen3 also sequence parallel) held to the CPU step
   from the same parameters and batch by phase 8's rule; minicpm3-4b at
   its published widths, batch 2 x 4096, for 2 steps from each rank's
   blocks of phase 8's draw (FSDP over data, tensor parallel over model;
   each rank and step: the wall around a barrier plus synchronize, calls,
   bytes, host and card seconds per collective kind, peak memory), step
   1's loss held to phase 8's one-card bf16 step 1 within 1.5 x the
   rounding floor phase 8 measures (its bf16 step 1 against its
   f32-weight step 1), every block's gradient finite and nonzero, step 1
   changing at least half the weights.  On a (1, 4) grid: qwen3-14b
   served through ``serve_lm``, prefill 4 x 512 and 32 greedy decode
   steps, B6 on each rank's 10 q and 2 kv heads (40 wgmma launches on
   prefill and 40 split launches a decode step, per rank); each B6 call
   of prefill and 4 decode steps fed phase 7's ids held to its plain
   version, and the logits of those steps and of every greedy step whose
   ids so far are phase 7's held to phase 7's one-card logits within
   MODEL_FLOOR_FACTOR x phase 7's floor; the phase fails past 240 s.  The
   B6 entry's launches add the meshed ones, in a case of their own;
11. the dry run and the examples (``[dryrun]`` and ``[check] dryrun``
   lines): ``repro_torch.launch.dryrun`` traces, on meta tensors, rank 0
   of this run's meshes: qwen3-14b's prefill 4 x 512 and one decode step
   over a dry (1, 4) mesh, whose calls and bytes per collective kind must
   equal phase 10's rank 0, and gin-tu's meshed step on phase 9's graph
   over a dry (4, 1) mesh, equal to phase 9's rank 0; then qwen3-14b's
   prefill and gin-tu's ``ogb_products`` step on one card, whose dry
   peaks must be within 15% of phases 7's and 8's own (an extra prefill
   and an extra warm step there, the memory held before each that is not
   its argument left out), and the same for gin-tu's meshed step (rank 0's
   block) against phase 9's rank 0's last step and minicpm3-4b's
   1 x 32,768 prefill against phase 7's (traced here, after the measured
   phases, at 2 and 3 of its 62 layers: the arguments counted whole, and
   each further layer adding the latent and RoPE-key cache it keeps,
   which the two traces must differ by); no trace may launch a kernel.
   Then the four
   examples in process on the card: ``quickstart_torch`` against its
   ``--device cpu`` run (BFS levels equal, PageRank within 1e-4, Table I
   equal; B1 launched), ``graph_analytics_torch --scale 12 --ranks 4
   --stream 2 --trace build/graph_analytics_trace.json`` (B1, B2 and B3
   launched, PageRank mass 1 within 1e-3, BFS and SSSP reach the same
   vertices, the 4-rank service answered its 64 queries),
   ``train_lm_torch --demo --steps 20`` (the loss falls, a checkpoint at
   step 20, no B6) and ``serve_lm_torch`` (B6 launched); the phase fails
   past 90 s.

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
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

ADD_RTOL = ADD_ATOL = 1e-5         # kernel vs plain, f32 'add'
# B4: in-order f32 sums of rows of up to ~1e5 entries (RMAT hubs, summed
# in pieces of at most block_n), against a float64-accumulated plain version
SEG_TOL = 1e-4
B4_BLOCK_NS = (128, 256, 512, 1024, 2048)   # B4's merge-path shares timed
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
PAGERANK_ITERS = 20                # pagerank's default
SMALL_SCALE = 16                   # card vs CPU path
WALK_STEPS = 80                    # DeepWalk's walk length
SAMPLE_DRAWS = 1_000_000           # chi-square draws at the largest hub
SAGE_FANOUTS, SAGE_SEEDS = (25, 10), 1024   # GraphSAGE's fanouts
REPAIR_INSERTS = 4096
SERVICE_TRACE = os.path.join(ROOT, "build", "service_trace.json")
TUNE_SCALE = 16                    # the phase's sweep; the CLI sweeps 20
TUNE_OUT = os.path.join(ROOT, "build", "tuned_smoke.json")
TILE = ("block_rows", "block_cols", "tile_nnz")
DIST_RANKS = 4                     # ranks sharing the card (gloo)
DIST_BATCHED = 8                   # sssp_batched_distributed's lanes
DIST_K = 4                         # the async BFS's sync_interval
DIST_DIR = os.path.join(ROOT, "build", "dist")
DIST2_SVC_BUDGET = 8               # the mesh service's lanes (a cut: 32)
DIST2_SVC_TARGETS = 4              # Reachability + Distance per source
# distributed PageRank vs phase 3's: values average 1e-6 at RMAT-20, so
# the absolute floor sits well under them
DIST_PR_RTOL, DIST_PR_ATOL = 1e-4, 1e-9
DIST_SPMV_RTOL, DIST_SPMV_ATOL = 1e-4, 1e-5
MODEL_ARCH = "qwen3-14b"           # the LM config that fits one card whole
MODEL_BATCH, MODEL_PROMPT, MODEL_GEN = 4, 512, 32
# bf16 logits after 40 layers, per row over the vocab: kernel vs plain
# route, decode vs forward.  Two bf16 runs of the network that differ only
# in rounding (the plain route's decode against its own forward, exact f32
# attention in both) already differ by percents a row: an ulp of
# difference in one layer grows over the depth.  The phase measures that
# floor and holds the logits to MODEL_FLOOR_FACTOR times it, never above
# MODEL_LOGIT_TOL; a decode step read against the wrong position must
# fail.  B6 itself is held per call, on the model path's inputs, to
# ATTN_ROW_TOL.
MODEL_FLOOR_FACTOR = 1.5
MODEL_LOGIT_TOL = 5e-2
MODEL_PLAIN_STEPS = 4              # decode steps held to the plain route
MODEL_SHARE_STEPS = 8              # decode steps timed for B6's share
MODEL_F32_TOL = 1e-4               # mixtral smoke (f32), card vs CPU
# MLA serving (phase 7): minicpm3-4b at its published widths, prefill
# 1 x 32,768 (prefill_32k's sequence, batch cut 32 -> 1) through the online
# softmax, then greedy steps; its logits held on a 4 x 512 prompt
MLA_ARCH = "minicpm3-4b"
MLA_PROMPT, MLA_GEN = 32768, 8
MLA_CHECK_BATCH, MLA_CHECK_PROMPT = 4, 512
MLA_PEAK_LIMIT = 80e9              # bytes: the prefill must fit the card
# phase 11 traces that prefill at this many layers and one more, and
# carries the peak to the model's depth (a trace of every layer takes
# minutes of host time)
MLA_DRY_DEPTH = 2
# seconds a collective of the multi-rank phases waits for a peer before it
# raises, named: on one H100 over gloo phase 9's all-to-alls (267 MB a rank
# on average) take 0.3 s each and phase 10's all-reduces 0.03 s on average,
# so a slow host has room, and a stall ends long before a phase's budget
CHIP_COLL_TIMEOUT_S = 180.0
FM_TOL = 1e-5                      # fm, port vs a float64 plain gather
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


def descendants() -> list:
    """The processes this one started that are still running (its process
    tree, from /proc), as "pid command" strings."""
    parent = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as fh:
                stat = fh.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if fields[0] != "Z":
            parent[int(d)] = int(fields[1])
    tree, grew = {os.getpid()}, True
    while grew:
        new = {p for p, pp in parent.items() if pp in tree and p not in tree}
        tree |= new
        grew = bool(new)
    out = []
    for p in sorted(tree - {os.getpid()}):
        try:
            with open(f"/proc/{p}/cmdline", "rb") as fh:
                cmd = fh.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        out.append(f"{p} {cmd.strip()}")
    return out


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


def least_ms(nbytes: float, flops: float = 0) -> tuple:
    """(the least ms the card takes to move ``nbytes`` and do ``flops``
    bf16 operations, what binds it: 'bytes' or 'operations'), by
    ``kernels.cost.bound_s`` over the card's rates (``launch.mesh.HW``)."""
    from repro_torch.kernels import cost
    from repro_torch.launch.mesh import HW
    s, by = cost.bound_s(nbytes, flops, HW)
    return 1e3 * s, by


def bound_ms(bb, tile_active=None) -> float:
    """Least time at the card's memory rate for the bytes the kernel must
    move on these inputs (``kernels.cost.bbcsr_bytes``: 12 B per real slot
    of the tiles it processes, their tile_cb and tile_cnt, the tile_active
    flags (SpMSpV), rb_ptr, x (padded) and y)."""
    from repro_torch.kernels import cost
    return least_ms(cost.bbcsr_bytes(bb, tile_active))[0]


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
    from repro_torch.launch.mesh import HW
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
        f"{peak / HW['hbm_bw']!r} of the nominal "
        f"{HW['hbm_bw'] / 1e12!r} TB/s")
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


def attention_reading(got, want):
    """(largest per-row ||got - want|| / ||want||, largest element's
    |got - want| over its limit): got passes the B6 check iff the first is
    at most ATTN_ROW_TOL and the second at most 1."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    row = diff.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    limit = ATTN_TOL * (want.abs() + rms.clamp(max=1.0))
    return (float(row.max()), float((diff / limit.clamp_min(1e-30)).max()))


def own_block_left_out(sq: int, skv: int, causal: bool, window, device):
    """The B6 check's planted fault: the visible keys with each query
    row's own FAULT_BLOCK-key block left out."""
    import torch
    from repro_torch.kernels import ref
    qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=device)[None, :]
    return ref.attention_mask(sq, skv, causal, window, device) & \
        (kpos // FAULT_BLOCK != qpos // FAULT_BLOCK)


def ops_phase(args, seg, n_vertices: int, err: dict) -> dict:
    """Phase 6: the kernel entry point at the configs' widths.  Returns,
    per kernel, its launches in the checked calls and its timings; writes
    each kernel's largest |kernel - plain| into ``err``."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cost
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
    label = f"B4 segment_sum ({n_e}, {d_hidden}) -> ({n_vertices}, {d_hidden})"
    out, cnt = called(SS, "segment_sum", lambda: ops.segment_sum_sorted(
        data, seg, n_vertices))
    want = ref.segment_sum_ref(data, seg, n_vertices)
    held("segment_sum", label, out, want, SEG_TOL)
    plan = SS.SegmentPlan(seg, n_vertices)
    b4_repro(label, out, plan.offsets, data, None, want,
             lambda: ops.segment_sum_sorted(data, seg, n_vertices))
    del out, want
    lib_out = torch.zeros(n_vertices, d_hidden, device="cuda")
    rmat_case = dict(
        shape=f"RMAT-{args.scale} in-edges, sorted ids, d {d_hidden}",
        launches=cnt,
        ms=cuda_ms(lambda: ops.segment_sum_csr(data, plan.offsets, None),
                   args.reps),
        entry_ms=cuda_ms(lambda: ops.segment_sum_sorted(data, seg,
                                                        n_vertices),
                         args.reps),
        plan_ms=cuda_ms(lambda: SS.SegmentPlan(seg, n_vertices).offsets,
                        args.reps),
        plain_ms=cuda_ms(lambda: ref.segment_sum_ref(data, seg, n_vertices),
                         3, 1),
        bound_ms=b4_bound_ms(n_e, d_hidden, n_vertices),
        bound_by="bytes",
        library_ms=cuda_ms(lambda: lib_out.index_add_(0, seg, data),
                           args.reps),
        split_rows=SS.split_rows(plan.offsets, b4_block_n(n_vertices)),
        block_n_ms=b4_sweep(lambda bn: ops.segment_sum_csr(
            data, plan.offsets, None, block_n=bn), args.reps))
    log(f"[time] segment_sum {rmat_case['shape']}: kernel on its plan "
        f"{rmat_case['ms']!r} ms, the entry with its plan "
        f"{rmat_case['entry_ms']!r} ms (the plan alone "
        f"{rmat_case['plan_ms']!r} ms), {rmat_case['split_rows']} rows "
        f"split; by block_n {rmat_case['block_n_ms']}")
    del data, lib_out, seg, plan
    torch.cuda.empty_cache()
    cases = [rmat_case] + b4_gin_cases(args, gen, called, held)
    rows["segment_sum"] = dict(rmat_case, cases=cases, launches=sum(
        c["launches"] for c in cases))
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
            bound_ms=least_ms(stream_b + row_b)[0],
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
            f"{least_ms(stream_b + sector_b)[0]!r} ms counting "
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
        faulty = masked_attention(
            q, k, v, own_block_left_out(Sq, Skv, True, window, "cuda"))
        d, row, row_fault = held_attention(
            f"B6 {label} B{B} Hq{Hq} Hkv{Hkv} Sq{Sq} Skv{Skv} window "
            f"{window}", out,
            ref.flash_attention_ref(q, k, v, causal=True, window=window),
            faulty)
        del out, faulty
        # operations on the visible (query, key) pairs only, 4 D each
        least, least_by = least_ms(
            cost.attention_bytes(q.numel(), k.numel(), q.element_size()),
            cost.attention_flops(B, Hq, Sq, Skv, D, True, window))
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
            bound_ms=least, bound_by=least_by,
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


B6_KERNELS = ("flash_mma", "flash_simt", "flash_combine", "flash_wgmma")
MATMUL_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")


def profiled(fn, per: int) -> dict:
    """fn's kernels under ``torch.profiler``, per one of ``per`` units: ms
    of kernel time in all, in cuBLAS's matrix products and in B6; the
    kernel count; the top-level aten ops the host dispatched.  B6's share
    of the kernel time.  Device times are None where the profiler recorded
    no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()

    def us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0))

    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    host_ops = sum(1 for e in events if e.device_type == DeviceType.CPU and
                   e.cpu_parent is None and e.name.startswith("aten::"))
    total = sum(us(e) for e in kern)
    b6 = sum(us(e) for e in kern if any(n in e.name for n in B6_KERNELS))
    mm = sum(us(e) for e in kern
             if any(n in e.name.lower() for n in MATMUL_KERNELS))
    if total <= 0:
        return dict(device_ms=None, matmul_ms=None, b6_ms=None,
                    b6_share=None, kernels=len(kern) / per,
                    host_ops=host_ops / per)
    return dict(device_ms=total / 1e3 / per, matmul_ms=mm / 1e3 / per,
                b6_ms=b6 / 1e3 / per, b6_share=b6 / total,
                kernels=len(kern) / per, host_ops=host_ops / per)


def model_phase(args, smi: str) -> dict:
    """The model-serving phase: qwen3-14b at its published widths served
    through ``repro_torch.launch.serve.serve_lm`` (prefill MODEL_BATCH x
    MODEL_PROMPT, then MODEL_GEN greedy decode steps), its B6 launches
    counted per path; the kernel route held to the plain route and decode
    to forward, within a multiple of the rounding floor measured here (the
    plain route's decode against its own forward); B6's share of a decode
    step, by wall time and by device time; mixtral-8x7b's smoke config
    on the card against the CPU; fm at full width against a float64 plain
    gather.  Returns the phase's numbers; fails on any check."""
    import copy
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch.configs import get_config, input_specs
    from repro_torch.data import synthetic
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import recsys as RS
    from repro_torch.models import transformer as TF

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {"arch": MODEL_ARCH, "nvidia_smi": smi}
    cfg = get_config(MODEL_ARCH).model
    if TF.attention_route(cfg) != "flash":
        fail(f"{MODEL_ARCH} does not route attention to B6")
    Bm, P, G, L = MODEL_BATCH, MODEL_PROMPT, MODEL_GEN, cfg.n_layers
    t0 = time.perf_counter()
    model = TF.init_params(cfg, 0).requires_grad_(False)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["params"] = TF.count_params(model)
    out["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in model.parameters())
    log(f"[model] {MODEL_ARCH}: {out['params']} parameters, "
        f"{out['param_bytes'] / 1e9:.2f} GB, drawn on the card in "
        f"{out['init_s']!r} s; {L} layers d {cfg.d_model} {cfg.n_heads} "
        f"heads / {cfg.n_kv_heads} kv heads x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (Bm, P)).astype(np.int32)

    # -- the main path: B6's counts zeroed just before, read just after ----
    FA.reset_launches()
    run = serve_lm(cfg, model, prompts, G, keep_logits=True)
    counts = dict(FA.LAUNCHES)
    want = {"flash_attention": L * (1 + G), "flash_attention_wgmma": L}
    log(f"[model] B6 launches on the main path: {counts} (want "
        f"flash_attention {want['flash_attention']} = {L} on prefill + "
        f"{L} x {G} decode steps, wgmma {L} = prefill)")
    if any(counts[k] != v for k, v in want.items()):
        fail(f"the serving path's B6 launches {counts} are not {want}")
    out["b6_launches"] = counts
    steps = run["step_logits"]                      # (G, B, vocab) f32
    if steps.shape != (G, Bm, cfg.vocab) or \
            not bool(torch.isfinite(steps).all()) or \
            not bool(torch.isfinite(run["prefill_logits"]).all()):
        fail(f"serving logits {tuple(steps.shape)} not finite or not "
             f"({G}, {Bm}, {cfg.vocab})")
    out.update(prefill_s=run["prefill_s"], decode_s=run["decode_s"],
               decode_ms_per_token=1e3 * run["decode_s"] / G,
               tokens_per_s=run["tok_per_s"])
    warm = serve_lm(cfg, model, prompts, G)
    out.update(prefill_warm_s=warm["prefill_s"],
               decode_warm_ms_per_token=1e3 * warm["decode_s"] / G,
               tokens_per_s_warm=warm["tok_per_s"],
               same_tokens_warm=bool(np.array_equal(warm["tokens"],
                                                    run["tokens"])))
    del warm
    log(f"[model] prefill {Bm} x {P}: wall {run['prefill_s']!r} s, warm "
        f"{out['prefill_warm_s']!r} s ({smi})")
    log(f"[model] decode {G} steps at batch {Bm}: "
        f"{out['decode_ms_per_token']!r} ms per step, "
        f"{run['tok_per_s']!r} tokens/s; warm "
        f"{out['decode_warm_ms_per_token']!r} ms per step, "
        f"{out['tokens_per_s_warm']!r} tokens/s ({smi})")

    def row_err(got, want):
        """Largest per-row ||got - want|| / ||want|| over the vocab."""
        got, want = got.float(), want.float()
        return float(((got - want).norm(dim=-1)
                      / want.norm(dim=-1).clamp_min(1e-30)).max())

    # -- the rounding floor: the plain route's decode against its forward --
    def plain(q, k, v, *, causal=True, window=None):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)

    toks = torch.from_numpy(run["tokens"]).cuda()
    seq = torch.cat([torch.from_numpy(prompts).cuda().long(), toks], dim=1)
    FA.reset_launches()
    with mock.patch.object(ops, "flash_attention", plain):
        p_logits, cache = TF.prefill(cfg, model, prompts)
        cache = TF.grow_cache(cache, P + G)
        p_steps = []
        for t in range(G):                  # fed the kernel route's ids
            lg, cache = TF.decode_step(cfg, model, cache, toks[:, t:t + 1])
            p_steps.append(lg)
        del cache
        with torch.no_grad():
            p_fwd, _ = TF.forward(cfg, model, seq)
    torch.cuda.synchronize()
    if any(FA.LAUNCHES.values()):
        fail(f"the plain route launched B6: {FA.LAUNCHES}")
    floor = max([row_err(p_logits, p_fwd[:, P - 1])]
                + [row_err(p_steps[t], p_fwd[:, P + t]) for t in range(G)])
    del p_fwd
    limit = min(MODEL_LOGIT_TOL, MODEL_FLOOR_FACTOR * floor)
    out.update(logit_floor=floor, logit_limit=limit)
    # the one-card logits and ids phase 10's meshed serving is held to
    os.makedirs(LMMESH_DIR, exist_ok=True)
    torch.save(dict(prompts=torch.from_numpy(prompts),
                    tokens=torch.from_numpy(run["tokens"]),
                    prefill_logits=run["prefill_logits"].cpu(),
                    step_logits=steps.cpu(), floor=floor, limit=limit),
               LMMESH_SERVE_REF)
    log(f"[check] model rounding floor: plain route's prefill and decode "
        f"steps 0-{G - 1} vs its own forward, per row max ||a - b|| / ||b|| "
        f"= {floor!r}; the logits below are held to {MODEL_FLOOR_FACTOR} x "
        f"that = {limit!r} (at most {MODEL_LOGIT_TOL})")
    if not 0 < floor <= MODEL_LOGIT_TOL:
        fail(f"the rounding floor {floor!r} is outside (0, "
             f"{MODEL_LOGIT_TOL}]")

    def held(label, e, fault=None):
        log(f"[check] model {label}: per row max ||a - b|| / ||b|| = {e!r} "
            f"(limit {limit!r})"
            + ("" if fault is None else f"; planted fault {fault!r}"))
        if not e <= limit:
            fail(f"model {label}: {e!r} over {limit!r}")
        if fault is not None and fault <= limit:
            fail(f"model {label}: the planted fault passes the check")
        return e

    # -- the kernel route against the plain route, fed the same ids --------
    out["err_prefill_vs_plain"] = held(
        "prefill logits, kernel route vs plain route",
        row_err(run["prefill_logits"], p_logits))
    out["err_decode_vs_plain"] = held(
        f"decode steps 0-{MODEL_PLAIN_STEPS - 1}, kernel route vs plain "
        f"route", max(row_err(steps[t], p_steps[t])
                      for t in range(MODEL_PLAIN_STEPS)))
    del p_steps, p_logits

    # -- decode against forward over the prompt and the generated ids ------
    with torch.no_grad():
        fwd, _ = TF.forward(cfg, model, seq)
    out["err_prefill_vs_forward"] = held(
        f"prefill vs forward at position {P - 1}",
        row_err(run["prefill_logits"], fwd[:, P - 1]))
    # the planted fault: each step read against the next position
    out["err_decode_vs_forward"] = held(
        f"decode steps 0-{G - 1} vs forward at positions {P}-{P + G - 1}",
        max(row_err(steps[t], fwd[:, P + t]) for t in range(G)),
        fault=min(row_err(steps[t], fwd[:, P + t + 1])
                  for t in range(G - 1)))
    del fwd, seq

    # -- B6 on the model path, call by call, against its plain version -----
    real, readings, in_place = ops.flash_attention, [], []

    def checked(q, k, v, *, causal=True, window=None):
        if q.shape[2] == 1:
            in_place.append(FA.kv_rows(k, v))
        got = real(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        reading = attention_reading(got, want)
        if not readings or q.shape[2] != readings[-1][0]:
            # the planted fault on the first call of each kind
            faulty = masked_attention(q, k, v, own_block_left_out(
                q.shape[2], k.shape[2], causal, window, q.device))
            reading += attention_reading(faulty, want)
        readings.append((q.shape[2],) + reading)
        return got

    with mock.patch.object(ops, "flash_attention", checked):
        _, cache = TF.prefill(cfg, model, prompts)
        cache = TF.grow_cache(cache, P + G)
        for t in range(MODEL_PLAIN_STEPS):
            TF.decode_step(cfg, model, cache, toks[:, t:t + 1])
    del cache
    kernel_row = max(r[1] for r in readings)
    kernel_el = max(r[2] for r in readings)
    faults = [r[3:] for r in readings if len(r) > 3]
    log(f"[check] model B6 calls on the path ({len(readings)}: {L} prefill, "
        f"{L} x {MODEL_PLAIN_STEPS} decode) vs the plain version: per row "
        f"max {kernel_row!r} (limit {ATTN_ROW_TOL}), element max "
        f"{kernel_el!r} of its limit; planted faults (prefill, decode): "
        f"{faults!r}")
    if kernel_row > ATTN_ROW_TOL or kernel_el > 1.0:
        fail("B6 disagrees with its plain version on the model path")
    if len(faults) != 2 or any(f[0] <= ATTN_ROW_TOL and f[1] <= 1.0
                               for f in faults):
        fail("a planted fault passes the model path's B6 check")
    out.update(b6_row_err=kernel_row, b6_calls_checked=len(readings))
    log(f"[check] model B6 decode calls reading the cache in place (row "
        f"stride {P + G}, the cache's slots): "
        f"{sum(r == P + G for r in in_place)} of {len(in_place)}")
    if len(in_place) != L * MODEL_PLAIN_STEPS or \
            any(r != P + G for r in in_place):
        fail(f"B6's decode calls copy the cache: row strides {in_place}")

    # -- B6's share of a decode step: wall time between CUDA events around
    # its calls (the wrapper's host work included), and device time from
    # the profiler's kernel records
    real, pairs = ops.flash_attention, []

    def timed(*a, **kw):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        o = real(*a, **kw)
        e.record()
        pairs.append((s, e))
        return o

    _, cache = TF.prefill(cfg, model, prompts)
    cache = TF.grow_cache(cache, P + G)
    step_events = []
    with mock.patch.object(ops, "flash_attention", timed):
        for t in range(MODEL_SHARE_STEPS):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            TF.decode_step(cfg, model, cache, toks[:, t:t + 1])
            e.record()
            step_events.append((s, e))
    torch.cuda.synchronize()
    b6_ms = sum(s.elapsed_time(e) for s, e in pairs)
    step_ms = sum(s.elapsed_time(e) for s, e in step_events)
    out.update(b6_calls_timed=len(pairs), b6_ms_per_step=b6_ms /
               MODEL_SHARE_STEPS, step_ms_events=step_ms / MODEL_SHARE_STEPS,
               b6_wall_share=b6_ms / step_ms)
    log(f"[model] B6's wall share of a decode step: "
        f"{out['b6_wall_share']!r} ({out['b6_ms_per_step']!r} of "
        f"{out['step_ms_events']!r} ms per step between CUDA events, host "
        f"time included, {len(pairs)} calls over {MODEL_SHARE_STEPS} "
        f"steps) ({smi})")
    host_s = []

    def steps():
        t0 = time.perf_counter()
        for t in range(MODEL_SHARE_STEPS, 2 * MODEL_SHARE_STEPS):
            TF.decode_step(cfg, model, cache, toks[:, t:t + 1])
        torch.cuda.synchronize()
        host_s.append(time.perf_counter() - t0)

    dec = profiled(steps, MODEL_SHARE_STEPS)
    dec["host_ms"] = 1e3 * host_s[0] / MODEL_SHARE_STEPS
    pre = profiled(lambda: TF.prefill(cfg, model, prompts), 1)
    out.update(decode_profile=dec, prefill_profile=pre,
               b6_device_share=dec["b6_share"])
    for label, d in (("decode step", dec), ("prefill", pre)):
        if d["device_ms"] is None:
            log(f"[model] {label} by device time: not measured (the "
                f"profiler recorded no kernel)")
            continue
        log(f"[model] {label} by device time (torch.profiler): "
            f"{d['device_ms']!r} ms of kernels, matrix products "
            f"{d['matmul_ms']!r}, B6 {d['b6_ms']!r} (share "
            f"{d['b6_share']!r}), {d['kernels']!r} kernels, "
            f"{d['host_ops']!r} top-level aten ops"
            + (f"; {d['host_ms']!r} ms on the host clock under the "
               f"profiler" if "host_ms" in d else "") + f" ({smi})")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[model] peak memory {out['peak_gib']!r} GiB ({smi})")
    # one more prefill, its own peak kept for phase 11's dry run
    from repro_torch.launch.dryrun import storage_bytes
    out["prefill_peak"] = step_peak(
        lambda: TF.prefill(cfg, model, prompts), storage_bytes(model))
    log(f"[model] one prefill {Bm} x {P}: its own peak "
        f"{out['prefill_peak']['step_peak']} B ({out['prefill_peak']})")
    del cache, model, run, steps, toks
    torch.cuda.empty_cache()

    # -- mixtral-8x7b smoke: MoE and the ring past the window, card vs CPU -
    mcfg = get_config("mixtral-8x7b").smoke
    cpu_model = TF.Transformer(mcfg, seed=1, device="cpu")
    card_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(1)
    out["mixtral_smoke"] = []
    for prompt, gen in ((12, 6), (6, 10)):      # prefilled past the window;
        pr = rng.integers(0, mcfg.vocab, (2, prompt)).astype(np.int32)
        FA.reset_launches()                     # a window-sized ring
        got = serve_lm(mcfg, card_model, pr, gen, keep_logits=True)
        n = FA.LAUNCHES["flash_attention"]
        want = serve_lm(mcfg, cpu_model, pr, gen, keep_logits=True)
        d = max(float((got[k].cpu() - want[k]).abs().max())
                for k in ("prefill_logits", "step_logits"))
        same = bool(np.array_equal(got["tokens"], want["tokens"]))
        log(f"[check] model mixtral smoke prompt {prompt} gen {gen} "
            f"(window {mcfg.window}): card vs CPU max |diff| {d!r} (limit "
            f"{MODEL_F32_TOL}), tokens equal {same}, B6 launches {n}")
        if not (d <= MODEL_F32_TOL and same and
                n == mcfg.n_layers * (1 + gen)):
            fail(f"mixtral smoke prompt {prompt}: card disagrees with CPU")
        out["mixtral_smoke"].append(dict(prompt=prompt, gen=gen,
                                         max_abs_diff=d, b6_launches=n))
    del cpu_model, card_model

    # -- fm at full width: serve_p99, serve_bulk, retrieval_cand -----------
    fac = get_config("fm")
    fcfg = fac.model
    params = RS.init_params(fcfg, 0)
    gen_t = torch.Generator(device="cuda").manual_seed(3)

    def fm_plain(ids):
        rows = params["table"][ids.long()].double()
        v = rows[..., 1:]
        s = v.sum(-2)
        return (params["w0"].double() + rows[..., 0].sum(-1)
                + 0.5 * ((s * s).sum(-1) - (v * v).sum((-2, -1))))

    out["fm"] = {}
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        spec = input_specs(fac, shape).batch
        ids = torch.from_numpy(next(synthetic.recsys_batches(
            spec["ids"].shape[0], fcfg.n_fields, fcfg.rows_per_field,
            seed=5))["ids"]).cuda()
        if shape == "retrieval_cand":
            cand = torch.randn(spec["cand"].shape, device="cuda",
                               generator=gen_t)
            bias = torch.randn(spec["cand_bias"].shape, device="cuda",
                               generator=gen_t)

            def call():
                return RS.retrieval_scores(fcfg, params, ids, cand, bias)
            rows = params["table"][ids[0].long()].double()
            v = rows[:, 1:]
            u = v.sum(0)
            want = (params["w0"].double() + rows[:, 0].sum()
                    + 0.5 * ((u * u).sum() - (v * v).sum())
                    + bias.double() + cand.double() @ u)
        else:
            def call():
                return RS.fm_scores(fcfg, params, ids)
            want = fm_plain(ids)
        got = call()
        torch.cuda.synchronize()
        d = float((got.double() - want).abs().max())
        ok = got.shape == want.shape and bool(torch.allclose(
            got.double(), want, rtol=FM_TOL, atol=FM_TOL))
        ms = cuda_ms(call, args.reps)
        log(f"[model] fm {shape} ({tuple(ids.shape)} ids): {ms!r} ms per "
            f"call ({smi})")
        log(f"[check] model fm {shape}: max |port - float64 plain gather| "
            f"{d!r} (rtol/atol {FM_TOL})")
        if not ok:
            fail(f"fm {shape}: the port disagrees with the plain gather")
        out["fm"][shape] = dict(ms=ms, max_abs_err=d,
                                shape=list(ids.shape))
    del params
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[model] phase wall {out['phase_s']!r} s")
    return out


def dry_mla_prefill() -> dict:
    """The dry run's peak of phase 7's MLA prefill (MLA_ARCH, 1 x
    MLA_PROMPT, one card) on meta tensors, from traces of the model cut
    to MLA_DRY_DEPTH layers and to one more: the arguments are the whole
    model's and the prompt's, and each layer past the traced ones adds
    the cache it keeps to the end (the latent and the RoPE key of every
    position, in the model's dtype), which the two traces' temporaries
    (peak less arguments) must differ by.  ``TraceCounter`` alone: the
    peak, without the FLOP count."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models import transformer as TF
    cfg = get_config(MLA_ARCH).model
    toks = torch.empty((1, MLA_PROMPT), dtype=torch.int32, device="meta")
    t0 = time.perf_counter()
    temps = []
    for depth in (MLA_DRY_DEPTH, MLA_DRY_DEPTH + 1):
        cut = dataclasses.replace(cfg, n_layers=depth)
        model = TF.init_params(cut, device="meta")
        tc = D.TraceCounter()
        held = tc.hold((model, toks))
        with tc:
            TF.prefill(cut, model, toks)
        temps.append(tc.peak - held)
    m = cfg.mla
    layer_cache = MLA_PROMPT * (m.kv_lora_rank + m.rope_head_dim) * \
        torch.empty((), dtype=cfg.dtype).element_size()
    args = D.storage_bytes((TF.init_params(cfg, device="meta"), toks))
    return {"peak_bytes": args + temps[0] + (cfg.n_layers - MLA_DRY_DEPTH)
            * layer_cache, "argument_bytes": args,
            "temporaries": dict(zip((MLA_DRY_DEPTH, MLA_DRY_DEPTH + 1),
                                    temps)),
            "layer_cache_bytes": layer_cache,
            "trace_s": time.perf_counter() - t0}


def mla_phase(smi: str) -> dict:
    """Phase 7's MLA serving: MLA_ARCH at its published widths served
    through ``serve_lm``, prefill 1 x MLA_PROMPT through the online softmax
    (``transformer.online_attention``, once a layer; no B6) and MLA_GEN
    greedy steps (the absorbed latent decode), its prefill wall, decode ms
    a step and peak memory (under MLA_PEAK_LIMIT), the prefill's own peak
    kept for phase 11's dry run; then on a MLA_CHECK_BATCH x
    MLA_CHECK_PROMPT prompt the online route held to the plain route
    (``ref.flash_attention_ref``) by phase 7's floor rule: the plain
    route's prefill and decode against its own ``forward`` give the floor,
    and prefill and ``forward`` of both routes must agree within
    MODEL_FLOOR_FACTOR x it, at most MODEL_LOGIT_TOL."""
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.launch.dryrun import storage_bytes
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer as TF

    t_phase = time.perf_counter()
    cfg = get_config(MLA_ARCH).model
    out = {"arch": MLA_ARCH, "nvidia_smi": smi}
    if TF.attention_route(cfg) != "online":
        fail(f"{MLA_ARCH} does not route attention to the online softmax")
    L = cfg.n_layers
    t0 = time.perf_counter()
    model = TF.init_params(cfg, 0).requires_grad_(False)
    torch.cuda.synchronize()
    out.update(init_s=time.perf_counter() - t0,
               params=TF.count_params(model),
               param_bytes=storage_bytes(model))
    m = cfg.mla
    log(f"[model] {MLA_ARCH}: {out['params']} parameters, "
        f"{out['param_bytes'] / 1e9:.2f} GB, drawn in {out['init_s']!r} s; "
        f"{L} layers d {cfg.d_model} {cfg.n_heads} heads, MLA q / k width "
        f"{m.nope_head_dim + m.rope_head_dim}, v {m.v_head_dim}, latent "
        f"{m.kv_lora_rank}, vocab {cfg.vocab}, {cfg.dtype}")
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab, (1, MLA_PROMPT)).astype(np.int32)

    # -- the main path: serve_lm, the prefill's own peak measured around it -
    real_prefill, real_online = TF.prefill, TF.online_attention
    rec, online = {}, []

    def measured_prefill(*a, **kw):
        torch.cuda.synchronize()
        rec["held"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = real_prefill(*a, **kw)
        torch.cuda.synchronize()
        rec["peak"] = torch.cuda.max_memory_allocated()
        return res

    def counted(*a, **kw):
        online.append(tuple(a[0].shape))
        return real_online(*a, **kw)

    FA.reset_launches()
    with mock.patch.object(TF, "prefill", measured_prefill), \
            mock.patch.object(TF, "online_attention", counted):
        run = serve_lm(cfg, model, prompts, MLA_GEN)
    peak = torch.cuda.max_memory_allocated()
    b6 = dict(FA.LAUNCHES)
    out["prefill_peak"] = dict(peak=rec["peak"], held=rec["held"],
                               args=out["param_bytes"],
                               step_peak=rec["peak"] - rec["held"]
                               + out["param_bytes"])
    out.update(prefill_s=run["prefill_s"],
               decode_ms_per_step=1e3 * run["decode_s"] / MLA_GEN,
               tokens_per_s=run["tok_per_s"], peak_bytes=peak,
               online_calls=len(online), b6_launches=b6)
    log(f"[model] {MLA_ARCH} prefill 1 x {MLA_PROMPT} through the online "
        f"softmax: wall {run['prefill_s']!r} s; decode {MLA_GEN} greedy "
        f"steps: {out['decode_ms_per_step']!r} ms a step; peak "
        f"{peak} B ({peak / 2**30:.2f} GiB; the prefill's own "
        f"{out['prefill_peak']['step_peak']} B) ({smi})")
    ok = (run["tokens"].shape == (1, MLA_GEN) and len(online) == L
          and all(sh[2] == MLA_PROMPT for sh in online)
          and not any(b6.values())
          and bool(torch.isfinite(run["logits"]).all()))
    log(f"[check] model {MLA_ARCH} prefill {MLA_PROMPT}: online-softmax "
        f"calls {len(online)} (want {L}, one a layer), B6 launches {b6} "
        f"(want none: MLA's widths are not B6's), {MLA_GEN} tokens, finite "
        f"logits: {'ok' if ok else 'FAILED'}")
    log(f"[check] model {MLA_ARCH} peak {peak} B under {MLA_PEAK_LIMIT:.0f}"
        f" B: {'ok' if peak < MLA_PEAK_LIMIT else 'FAILED'}")
    if not ok or peak >= MLA_PEAK_LIMIT:
        fail(f"{MLA_ARCH} serving at {MLA_PROMPT} failed its checks")
    del run

    # -- the online route against the plain route, 4 x 512 ----------------
    def row_err(got, want):
        got, want = got.float(), want.float()
        return float(((got - want).norm(dim=-1)
                      / want.norm(dim=-1).clamp_min(1e-30)).max())

    def plain(q, k, v, *, causal=True, window=None, k_chunk=None):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)

    Bc, Pc, G = MLA_CHECK_BATCH, MLA_CHECK_PROMPT, MLA_GEN
    pr = np.random.default_rng(3).integers(0, cfg.vocab, (Bc, Pc)).astype(
        np.int32)
    run = serve_lm(cfg, model, pr, G, keep_logits=True)
    toks = torch.from_numpy(run["tokens"]).cuda()
    seq = torch.cat([torch.from_numpy(pr).cuda().long(), toks], dim=1)
    with torch.no_grad():
        o_fwd, _ = TF.forward(cfg, model, seq[:, :Pc])
    with mock.patch.object(TF, "online_attention", plain):
        p_logits, cache = TF.prefill(cfg, model, pr)
        cache = TF.grow_cache(cache, Pc + G)
        p_steps = []
        for t in range(G):
            lg, cache = TF.decode_step(cfg, model, cache, toks[:, t:t + 1])
            p_steps.append(lg)
        del cache
        with torch.no_grad():
            p_fwd, _ = TF.forward(cfg, model, seq)
    floor = max([row_err(p_logits, p_fwd[:, Pc - 1])]
                + [row_err(p_steps[t], p_fwd[:, Pc + t]) for t in range(G)])
    limit = min(MODEL_LOGIT_TOL, MODEL_FLOOR_FACTOR * floor)
    errs = {"prefill": row_err(run["prefill_logits"], p_logits),
            "forward": row_err(o_fwd, p_fwd[:, :Pc])}
    out.update(logit_floor=floor, logit_limit=limit, err_vs_plain=errs)
    good = 0 < floor <= MODEL_LOGIT_TOL and all(e <= limit
                                                 for e in errs.values())
    log(f"[check] model {MLA_ARCH} {Bc} x {Pc}: online route vs plain route,"
        f" per row max ||a - b|| / ||b||: prefill {errs['prefill']!r}, "
        f"forward over the prompt {errs['forward']!r}; the plain route's "
        f"floor (its prefill and {G} decode steps vs its own forward) "
        f"{floor!r}, limit {MODEL_FLOOR_FACTOR} x that = {limit!r} (at most "
        f"{MODEL_LOGIT_TOL}): {'ok' if good else 'FAILED'}")
    if not good:
        fail(f"{MLA_ARCH}: the online route disagrees with the plain route")
    del model, run, p_fwd, o_fwd, p_steps, p_logits
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[model] {MLA_ARCH} part wall {out['phase_s']!r} s")
    return out


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
        bound_ms=least_ms(m * (4 + 4 * W) + n * 4 * W)[0],
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


FADD_SRC = r"""
#include <cuda_runtime.h>
extern "C" __global__ void chain(const float* in, float* out,
                                 long long* cycles, int n) {
    float x = in[0], y = in[1];
    long long t0 = clock64();
    for (int i = 0; i < n; i += 8) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
            asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(x) : "f"(y));
    }
    long long t1 = clock64();
    out[0] = x;
    cycles[0] = t1 - t0;
}
extern "C" int run_chain(int n, float* ms, long long* cycles) {
    float *in, *out; long long* cyc;
    float h[2] = {1.0f, 1e-7f};
    cudaMalloc(&in, 8); cudaMalloc(&out, 4); cudaMalloc(&cyc, 8);
    cudaMemcpy(in, h, 8, cudaMemcpyHostToDevice);
    cudaEvent_t a, b;
    cudaEventCreate(&a); cudaEventCreate(&b);
    chain<<<1, 1>>>(in, out, cyc, 8);
    cudaEventRecord(a);
    chain<<<1, 1>>>(in, out, cyc, n);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    cudaEventElapsedTime(ms, a, b);
    cudaMemcpy(cycles, cyc, 8, cudaMemcpyDeviceToHost);
    cudaFree(in); cudaFree(out); cudaFree(cyc);
    cudaEventDestroy(a); cudaEventDestroy(b);
    return (int)cudaGetLastError();
}
"""


def fadd_chain_floor(chain: int, n: int = 1 << 26) -> dict:
    """The floor an in-order run sum's longest run sets: ``run_sum`` adds
    each run's weights in stream order, so a run of ``chain`` items is that
    many dependent f32 adds.  One thread adds a value to an accumulator
    ``n`` times through ``add.rn.f32`` (no FMA contraction, no
    reordering), timed by ``clock64`` and by CUDA events (best of 5): the
    cycles per add are the FADD latency, cycles over seconds the SM clock,
    and ``chain`` times the seconds per add the floor."""
    import ctypes
    out = os.path.join(ROOT, "build", "fadd_chain")
    os.makedirs(out, exist_ok=True)
    src, lib = os.path.join(out, "chain.cu"), os.path.join(out, "chain.so")
    with open(src, "w") as fh:
        fh.write(FADD_SRC)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                   check=True)
    so = ctypes.CDLL(lib)
    ms, cyc = ctypes.c_float(), ctypes.c_longlong()
    best = None
    for _ in range(5):
        if so.run_chain(n, ctypes.byref(ms), ctypes.byref(cyc)):
            fail("the FADD chain kernel failed")
        if best is None or ms.value < best[0]:
            best = (ms.value, cyc.value)
    t_ms, cycles = best
    ns = t_ms * 1e6 / n
    return dict(cycles_per_add=cycles / n, ns_per_add=ns,
                sm_ghz=cycles / (t_ms * 1e-3) / 1e9, chain=chain,
                floor_ms=chain * ns / 1e6)


def structured_phase(g, lv_p, d_p, cc_labels, delta, counted, err,
                     args) -> dict:
    """The structured phase on phase 4's graph: LPA and multi-level Louvain
    (reproducible, and equal to the CPU path at SMALL_SCALE), the
    segment_mode kernel's two entry points alone against their plain
    versions, walks and sampling held to the graph's edges and to their
    distributions, and repair after REPAIR_INSERTS inserts held to fresh
    runs.  Every path runs with the launch counts zeroed just before it and
    read just after.  Returns segment_mode's row of the kernels line (its
    launches those of the phase's paths), the phase's numbers, LPA's
    labels and, for the second distributed phase, the walks, multilevel's
    labels and scores, the graph after the inserts with the changed
    vertices, and the repaired BFS levels and CC labels (host arrays)."""
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
    out, launched, kept = {}, {}, {}

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
        bound_ms=least_ms(12 * dst.numel() + 8 * n)[0],
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
        bound_ms=least_ms(8 * m + 4 * n_runs)[0],
        bound_by="bytes", library_ms=None)
    log(f"[time] run_sum: kernel {sum_case['ms']!r} ms, plain "
        f"{sum_case['plain_ms']!r} ms, bound {sum_case['bound_ms']!r} ms, "
        f"library none")
    floor = fadd_chain_floor(longest)
    sum_case["chain_floor"] = floor
    log(f"[time] run_sum's order floor: {floor['cycles_per_add']!r} cycles "
        f"per dependent f32 add at {floor['sm_ghz']!r} GHz "
        f"({floor['ns_per_add']!r} ns), so its longest run of {longest} "
        f"adds takes at least {floor['floor_ms']!r} ms")
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
    kept["walks"] = walks.cpu().numpy()
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
    kept.update(new_indptr=csr.indptr.cpu().numpy(),
                new_indices=csr.indices.cpu().numpy(),
                new_values=csr.values.cpu().numpy(),
                changed_sources=np.asarray(rep.changed_sources),
                changed_vertices=np.asarray(rep.changed_vertices))
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
    kept.update(repair_bfs=prev["bfs"].cpu().numpy(),
                repair_cc=prev["cc"].cpu().numpy())
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
    kept.update(ml=ml.cpu().numpy(), ml_scores=np.array(scores))
    return row, out, lpa, kept


def _dist_check(checks, name, ok, detail=""):
    checks.append((name, bool(ok), detail))


def _dist_levels(checks, label, stats, *, S, program, payload, cap, m,
                 m_rev=None, flush_bytes=None, planes=0):
    """Each level's collectives and routed bytes against the traffic
    model: a sync level makes ``level_collectives(placement='sync', ...)``,
    a push level routes ``push_level_route_bytes`` at its capacity (the
    compacted one unless it fell back), a pull level's dgas gather routes
    index, validity and value planes over the reverse graph's ``m_rev``
    edges per shard (S * m_rev * (4 + 1 + 4) bytes), an async check makes
    ``level_collectives(placement='async')`` and routes
    ``flush_route_bytes``.  ``planes``: routed value planes past the
    model's one (each one all_to_all more)."""
    from repro_torch.core import traffic
    bad = []
    for i, lv in enumerate(stats["levels"]):
        routed = lv["bytes"]["all_to_all"]
        if flush_bytes is not None:
            want = (traffic.level_collectives(placement="async"), flush_bytes)
        elif lv["push"]:
            c = cap if 0 < cap < m and not lv["fallback"] else m
            want = (traffic.level_collectives(
                placement="sync", program_collectives=program) + planes,
                traffic.push_level_route_bytes(S, c, payload))
        else:
            want = (traffic.level_collectives(
                placement="sync", program_collectives=program) + planes,
                S * m_rev * (4 + 1 + 4) if m_rev else None)
        if (lv["collectives"], routed) != want:
            bad.append((i, lv["collectives"], routed, want))
    _dist_check(checks, f"{label} collectives and bytes vs traffic", not bad,
                f"{len(stats['levels'])} levels; mismatches {bad[:3]}")


def dist_rank(mesh, spec):
    """One rank of the distributed phase: its shards on the card, every
    path with the mesh's counts and the kernels' launch counts zeroed
    just before it and read just after; rank 0 gathers each result,
    unshards it and holds it to the saved local result."""
    import numpy as np
    import torch
    from repro_torch import tune
    from repro_torch.core import dgas, engine
    from repro_torch.core.algorithms import (
        GraphShard, bfs_distributed, connected_components_distributed,
        label_propagation_distributed, msbfs_distributed,
        pagerank_distributed, spmv_distributed, sssp_batched_distributed,
        sssp_distributed, unshard_vertex_array)
    from repro_torch.core import traffic
    from repro_torch.kernels import segment_mode as SM
    from repro_torch.kernels import segment_or as SO

    S, r, dev = mesh.size, mesh.rank, mesh.device
    d = spec["dir"]

    def load(name):
        return np.load(os.path.join(d, name + ".npy"), mmap_mode="r")

    def shard(name):
        return GraphShard(*(torch.from_numpy(np.array(load(f"{name}_{f}")[r]))
                            .to(dev) for f in ("src", "dst", "val")),
                          spec["n"], S, r)

    t0 = time.perf_counter()
    fwd, rev, sym = shard("fwd"), shard("rev"), shard("sym")
    lpa_t = shard("lpa")
    att = dgas.custom_boundary_rule(load("att"), spec["n"])
    att_s = dgas.custom_boundary_rule(load("att_sym"), spec["n"])
    x_att = dgas.block_rule(spec["n"], S)
    gid, real = x_att.resident(r, "cpu")
    x_local = torch.where(real, torch.from_numpy(np.array(load("x")))[
        gid.clamp(max=spec["n"] - 1)], 0.0).to(dev)
    load_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    paths, checks, results = {}, [], {}

    def run(label, fn):
        torch.cuda.synchronize(dev)
        mesh.barrier()
        mesh.reset_counts()
        SO.reset_launches()
        SM.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        counts = mesh.counts()
        mesh.barrier()
        wall = time.perf_counter() - t0
        res, stats = out if isinstance(out, tuple) else (out, None)
        row = {"wall_s": wall, "collectives": counts["collectives"],
               "bytes": counts["bytes"], "seconds": counts["seconds"],
               "card_seconds": counts["card_seconds"],
               "launches": {"segment_or": SO.LAUNCHES["segment_or"],
                            "segment_mode": SM.LAUNCHES["segment_mode"]}}
        if stats is not None:
            row.update({k: stats[k] for k in ("iters", "pushes", "pulls",
                                              "fallbacks")})
            row["levels"] = stats["levels"]
        paths[label] = row
        results[label] = mesh.gather(res)
        return stats

    n = spec["n"]
    sw = tune.resolve("engine.switch_frac", None, n=n, device=dev)
    cap = engine.frontier_edge_capacity(fwd.edges_per_shard, sw, n=n,
                                        device=dev)
    cap_s = engine.frontier_edge_capacity(sym.edges_per_shard, sw, n=n,
                                          device=dev)
    st = {}
    st["bfs auto"] = run("bfs auto", lambda: bfs_distributed(
        fwd, att, 0, mesh, g_rev=rev, mode="auto", return_stats=True))
    st["sssp"] = run("sssp", lambda: sssp_distributed(
        fwd, att, 0, mesh, delta=spec["delta"], return_stats=True))
    st["cc"] = run("cc", lambda: connected_components_distributed(
        sym, att_s, mesh, return_stats=True))
    st["pagerank"] = run("pagerank", lambda: pagerank_distributed(
        fwd, att, mesh, iters=spec["pr_iters"], return_stats=True))
    for mode in ("dgas", "allgather"):
        run(f"spmv {mode}", lambda: spmv_distributed(fwd, x_local, x_att,
                                                     att, mesh, mode=mode))
    sources = np.array(spec["sources"], np.int32)
    st["msbfs"] = run("msbfs", lambda: msbfs_distributed(
        fwd, att, sources, mesh, return_stats=True))
    st["sssp_batched"] = run("sssp_batched", lambda: sssp_batched_distributed(
        fwd, att, sources[:spec["batched"]], mesh, delta=spec["delta"],
        return_stats=True))
    st["lpa"] = run("lpa", lambda: label_propagation_distributed(
        lpa_t, x_att, mesh, iters=spec["lpa_iters"], return_stats=True))
    st["bfs async"] = run("bfs async", lambda: bfs_distributed(
        fwd, att, 0, mesh, placement="async", sync_interval=spec["k"],
        return_stats=True))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    mine = {"rank": r, "backend": mesh.backend, "device": str(dev),
            "load_s": load_s, "peak_gib": peak, "paths": paths}
    if r != 0:
        return mine

    # -- rank 0: the results against the local ones -----------------------
    def glob(label, a=att):
        return unshard_vertex_array(results[label], a)

    def exact(name, got, want):
        same = torch.equal(got, torch.from_numpy(np.asarray(want)))
        _dist_check(checks, name, same, "bit-equal" if same else "differs")

    exact("bfs auto vs phase 3 bfs", glob("bfs auto"), load("ref_bfs"))
    exact("bfs async vs phase 3 bfs", glob("bfs async"), load("ref_bfs"))
    exact("sssp vs phase 3 sssp", glob("sssp"), load("ref_sssp"))
    exact("cc vs phase 3 cc", glob("cc", att_s), load("ref_cc"))
    pr = glob("pagerank")
    want = torch.from_numpy(np.array(load("ref_pagerank")))
    diff = float((pr - want).abs().max())
    mass = float(pr.double().sum())
    _dist_check(checks, "pagerank vs phase 3 pagerank",
                torch.allclose(pr, want, rtol=DIST_PR_RTOL,
                               atol=DIST_PR_ATOL) and abs(mass - 1) <= 1e-3,
                f"max |diff| {diff!r}, mass {mass!r} (rtol {DIST_PR_RTOL} "
                f"atol {DIST_PR_ATOL})")
    y_ref = torch.from_numpy(np.array(load("ref_spmv")))
    for mode in ("dgas", "allgather"):
        y = glob(f"spmv {mode}")
        _dist_check(checks, f"spmv {mode} vs local spmv",
                    torch.allclose(y, y_ref, rtol=DIST_SPMV_RTOL,
                                   atol=DIST_SPMV_ATOL),
                    f"max |diff| {float((y - y_ref).abs().max())!r}")
    lv_b, d_b = load("ref_msbfs"), load("ref_sssp_batched")
    bad = [b for b in range(len(sources)) if not torch.equal(
        unshard_vertex_array(results["msbfs"][:, b], att),
        torch.from_numpy(np.array(lv_b[b])))]
    _dist_check(checks, f"msbfs {len(sources)} lanes vs phase 4 msbfs",
                not bad, f"lanes differing {bad}")
    bad = [b for b in range(spec["batched"]) if not torch.equal(
        unshard_vertex_array(results["sssp_batched"][:, b], att),
        torch.from_numpy(np.array(d_b[b])))]
    _dist_check(checks, f"sssp_batched {spec['batched']} lanes vs phase 4",
                not bad, f"lanes differing {bad}")
    exact("lpa vs the structured phase's lpa", glob("lpa", x_att),
          load("ref_lpa"))
    for k, label in (("segment_or", "msbfs"), ("segment_mode", "lpa")):
        _dist_check(checks, f"{k} launched on the {label} path",
                    paths[label]["launches"][k] > 0,
                    f"{paths[label]['launches'][k]} launches on this rank")

    # -- each level's collectives and bytes against the traffic model ------
    m, m_s = fwd.edges_per_shard, sym.edges_per_shard
    m_t = lpa_t.edges_per_shard
    P = traffic.ROUTE_PAYLOAD_BYTES
    for label, kw in (
            ("bfs auto", dict(program=0, payload=P, cap=cap, m=m,
                              m_rev=rev.edges_per_shard)),
            ("sssp", dict(program=2, payload=P, cap=cap, m=m)),
            ("cc", dict(program=0, payload=P, cap=cap_s, m=m_s)),
            ("pagerank", dict(program=1, payload=P, cap=cap, m=m)),
            ("msbfs", dict(program=0, cap=cap, m=m,
                           payload=traffic.batched_payload_bytes(
                               len(sources), packed=True))),
            ("sssp_batched", dict(program=2, cap=cap, m=m,
                                  payload=traffic.batched_payload_bytes(
                                      spec["batched"]))),
            # (voter, label, weight) and validity: 4 + 4 + 4 + 1 bytes in
            # four planes, one more than the model's index / value /
            # validity
            ("lpa", dict(program=0, payload=13, cap=0, m=m_t, planes=1)),
            ("bfs async", dict(program=0, payload=P, cap=0, m=m,
                               flush_bytes=traffic.flush_route_bytes(
                                   S, att.per_shard, 4)))):
        _dist_levels(checks, label, st[label], S=S, **kw)
    mine["checks"] = checks
    mine["caps"] = {"fwd": [cap, m], "sym": [cap_s, m_s], "lpa": [0, m_t]}
    return mine


def dist_nccl_rank(mesh, spec):
    """The 1-rank NCCL mesh: direction-optimizing BFS on the whole graph
    (one shard), the backend a multi-card cell would use."""
    import numpy as np
    import torch
    from repro_torch.core import engine
    from repro_torch.core.algorithms import bfs_distributed, shard_graph
    from repro_torch.core.graph import csr_from_numpy
    d, n, dev = spec["dir"], spec["n"], mesh.device
    load = lambda name: np.load(os.path.join(d, name + ".npy"))
    csr = csr_from_numpy(load("indptr"), load("indices"), load("values"), n,
                         n, device=dev)
    g1, att1 = shard_graph(csr, 1)
    rev1 = engine.reverse_graph(csr, att1)
    fwd, rev = g1.shard(0, dev), rev1.shard(0, dev)
    torch.cuda.synchronize(dev)
    mesh.reset_counts()
    t0 = time.perf_counter()
    lv, stats = bfs_distributed(fwd, att1, 0, mesh, g_rev=rev, mode="auto",
                                return_stats=True)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    same = torch.equal(lv.cpu(), torch.from_numpy(load("ref_bfs")))
    return {"backend": mesh.backend, "wall_s": wall, "same": same,
            "counts": mesh.counts(),
            **{k: stats[k] for k in ("iters", "pushes", "pulls",
                                     "fallbacks")}}


def dist_phase(g, x, ref: dict, smi: str) -> dict:
    """The distributed phase: shard the graph once on the host (the
    degree-balanced rule; its reverse by the same rule; the symmetrized
    graph by its own; LPA's transpose by the block rule), save the shards and the earlier phases' results
    under build/dist, spawn DIST_RANKS ranks sharing the card over gloo
    (CUDA tensors) and run every distributed path there, then a 1-rank
    NCCL BFS.  Returns the phase's numbers; fails on any check."""
    import numpy as np
    import torch
    from repro_torch.core import engine
    from repro_torch.core.algorithms import shard_graph, symmetrize
    from repro_torch.core.dgas import block_rule
    from repro_torch.launch import mesh as M

    t_phase = time.perf_counter()
    log(f"[dist] card: {smi}")
    os.makedirs(DIST_DIR, exist_ok=True)
    gsh, att = shard_graph(g, DIST_RANKS)
    g_rev = engine.reverse_graph(g, att)
    gss, att_s = shard_graph(symmetrize(g), DIST_RANKS)
    # LPA's votes flow over the transpose, sharded by vote-source owner
    # under the block rule, so each run adds in ascending source order
    glpa, _ = shard_graph(g.transpose(), DIST_RANKS,
                          row_att=block_rule(g.n_rows, DIST_RANKS))
    arrays = {"att": att.boundaries.numpy(), "att_sym": att_s.boundaries.numpy(),
              "indptr": g.indptr.cpu().numpy(),
              "indices": g.indices.cpu().numpy(),
              "values": g.values.cpu().numpy(), "x": x.cpu().numpy(),
              **{f"ref_{k}": v for k, v in ref.items()}}
    for name, sg in (("fwd", gsh), ("rev", g_rev), ("sym", gss),
                     ("lpa", glpa)):
        for f in ("src", "dst", "val"):
            arrays[f"{name}_{f}"] = getattr(sg, f).numpy()
    for name, a in arrays.items():
        np.save(os.path.join(DIST_DIR, name + ".npy"), a)
    prep_s = time.perf_counter() - t_phase
    log(f"[dist] host sharding into {DIST_RANKS} (degree-balanced "
        f"boundaries {att.boundaries.tolist()}, per_shard {att.per_shard}; "
        f"{gsh.edges_per_shard} edges per shard, reverse "
        f"{g_rev.edges_per_shard}, symmetrized {gss.edges_per_shard}, LPA's "
        f"block-ruled transpose {glpa.edges_per_shard}) and saving: "
        f"{prep_s!r} s")
    del gsh, g_rev, gss, glpa, arrays
    torch.cuda.empty_cache()
    spec = dict(dir=DIST_DIR, n=g.n_rows, delta=float(ref["delta"]),
                pr_iters=int(ref["pr_iters"]), lpa_iters=LPA_ITERS,
                sources=[int(v) for v in ref["sources"]],
                batched=DIST_BATCHED, k=DIST_K)
    for init in ("init4", "init1"):
        if os.path.exists(os.path.join(DIST_DIR, init)):
            os.unlink(os.path.join(DIST_DIR, init))
    t0 = time.perf_counter()
    ranks = M.spawn(dist_rank, DIST_RANKS, device="cuda",
                    init_file=os.path.join(DIST_DIR, "init4"), args=(spec,),
                    timeout=900, coll_timeout=CHIP_COLL_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    rep = ranks[0]
    log(f"[dist] {DIST_RANKS} ranks on {[r['device'] for r in ranks]}, "
        f"backend {rep['backend']} (gloo over CUDA tensors: the ranks share "
        f"one card), spawn to exit {ranks_s!r} s; loading the shards "
        f"{[round(r['load_s'], 3) for r in ranks]} s; peak allocated per "
        f"rank {[round(r['peak_gib'], 3) for r in ranks]} GiB")
    log(f"[dist] capacities [compacted, full] {rep['caps']}")
    launched = {"segment_or": 0, "segment_mode": 0}
    for label, row in rep["paths"].items():
        walls = [r["paths"][label]["wall_s"] for r in ranks]
        stats = {k: row[k] for k in ("iters", "pushes", "pulls", "fallbacks")
                 if k in row}
        launches = {k: sum(r["paths"][label]["launches"][k] for r in ranks)
                    for k in launched}
        for k in launched:
            launched[k] += launches[k]
        inside = [sum(r["paths"][label]["seconds"].values()) for r in ranks]
        card = [sum(r["paths"][label]["card_seconds"].values())
                for r in ranks]
        log(f"[dist] {label}: wall {max(walls)!r} s (per rank {walls}); "
            f"{stats}; collectives {row['collectives']}, bytes per rank "
            f"{row['bytes']}; host seconds inside the collectives per rank "
            f"{inside} ({max(i / w for i, w in zip(inside, walls)):.3f} of "
            f"the wall at most); card seconds between the events around "
            f"them {card} ({min(c / w for c, w in zip(card, walls)):.3f} "
            f"to {max(c / w for c, w in zip(card, walls)):.3f} of the "
            f"wall); launches over the ranks {launches}")
    nccl = M.spawn(dist_nccl_rank, 1, device="cuda",
                   init_file=os.path.join(DIST_DIR, "init1"), args=(spec,),
                   timeout=600, coll_timeout=CHIP_COLL_TIMEOUT_S)[0]
    log(f"[dist] 1-rank {nccl['backend']} bfs auto: wall "
        f"{nccl['wall_s']!r} s, iters {nccl['iters']} pushes "
        f"{nccl['pushes']} pulls {nccl['pulls']}, collectives "
        f"{nccl['counts']['collectives']}; bit-equal to phase 3 "
        f"{nccl['same']}")
    checks = rep["checks"] + [("nccl bfs auto vs phase 3 bfs", nccl["same"],
                               f"backend {nccl['backend']}")]
    if nccl["backend"] != "nccl" or rep["backend"] != "gloo":
        checks.append(("backends", False, f"{rep['backend']} / "
                       f"{nccl['backend']}"))
    for name, ok, detail in checks:
        log(f"[check] dist {name}: {'ok' if ok else 'FAILED'}; {detail}")
    phase_s = time.perf_counter() - t_phase
    log(f"[dist] phase wall {phase_s!r} s (budget 120 s); sssp_batched over"
        f" {DIST_BATCHED} of the {len(spec['sources'])} sources, no other "
        f"cut")
    failed = [c[0] for c in checks if not c[1]]
    if failed:
        fail(f"the distributed phase failed: {failed}")
    return {"phase_s": phase_s, "prep_s": prep_s, "ranks_s": ranks_s,
            "launches": launched, "ranks": ranks, "nccl": nccl}


def _shard_of_saved(d, name, r, S, n, dev):
    import numpy as np
    import torch
    from repro_torch.core.algorithms import GraphShard
    return GraphShard(*(torch.from_numpy(np.array(np.load(
        os.path.join(d, f"{name}_{f}.npy"), mmap_mode="r")[r])).to(dev)
        for f in ("src", "dst", "val")), n, S, r)


def dist2_rank(mesh, spec):
    """One rank of the second distributed phase, on a (2, 2) grid whose
    flattened world is the 1-D mesh of DIST_RANKS: the queue engine and
    the walks, distributed Louvain, streaming on shards, the service sync
    and async, and BFS over the grid's tuple axis.  Every path runs with
    the mesh's counts, the kernels' launch counts and the peak memory
    reset just before it and read just after; rank 0 holds each result to
    the local one saved by the earlier phases."""
    import numpy as np
    import torch
    from repro_torch.core import dgas, offload
    from repro_torch.core.algorithms import (
        bfs_distributed, bfs_repair_distributed, cc_repair_distributed,
        multilevel_distributed, random_walks_distributed, shard_of,
        unshard_vertex_array, update_shards, walk_shards)
    from repro_torch.core.graph import csr_from_numpy
    from repro_torch.core.service import Distance, GraphService, Reachability
    from repro_torch.core.traffic import RouteByteCounter
    from repro_torch.kernels import segment_mode as SM
    from repro_torch.kernels import segment_or as SO
    from repro_torch.obs import get_registry

    AX = ("data", "model")
    w = mesh.over(AX)
    S, r, dev, d, n = w.size, w.rank, w.device, spec["dir"], spec["n"]

    def load(name, mmap=True):
        return np.load(os.path.join(d, name + ".npy"),
                       mmap_mode="r" if mmap else None)

    t0 = time.perf_counter()
    fwd, rev = (_shard_of_saved(d, k, r, S, n, dev) for k in ("fwd", "rev"))
    sym = _shard_of_saved(d, "sym", r, S, n, dev)
    att = dgas.custom_boundary_rule(load("att"), n)
    att_s = dgas.custom_boundary_rule(load("att_sym"), n)
    load_s = time.perf_counter() - t0
    paths, checks, results = {}, [], {}

    def run(label, fn):
        torch.cuda.synchronize(dev)
        mesh.barrier()
        mesh.reset_counts()
        SO.reset_launches()
        SM.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        mesh.settle()
        counts = mesh.counts()
        wall = time.perf_counter() - t0
        mesh.barrier()
        paths[label] = {
            "wall_s": wall, "collectives": counts["collectives"],
            "calls": counts["calls"], "bytes": counts["bytes"],
            "seconds": counts["seconds"],
            "card_seconds": counts["card_seconds"],
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "launches": {"segment_or": SO.LAUNCHES["segment_or"],
                         "segment_mode": SM.LAUNCHES["segment_mode"],
                         "run_sum": SM.LAUNCHES["run_sum"]}}
        return out

    def check(name, ok, detail=""):
        if r == 0:
            checks.append((name, bool(ok), detail))

    # -- the queue engine: a skewed queue, then the walks ------------------
    cap = spec["queue_cap"]
    cnt = spec["queue_counts"][r]
    q = offload.queue_make(cap, dev)
    q.items[:cnt] = torch.arange(cnt, dtype=torch.int32, device=dev) + \
        r * cap
    q.count = torch.tensor(cnt, dtype=torch.int32, device=dev)
    qb, pb = run("queue_balance", lambda: offload.queue_balance(
        q, w, q.items.to(torch.float32)))
    got = w.gather(torch.cat([qb.count.reshape(1).to(torch.float32), pb,
                              qb.items.to(torch.float32)]))
    if r == 0:
        counts = got[:, 0].long()
        items = got[:, 1 + cap:].reshape(-1)
        items = torch.sort(items[items >= 0]).values
        want = torch.cat([torch.arange(c, device=dev) + i * cap for i, c in
                          enumerate(spec["queue_counts"])]).to(items.dtype)
        pay_ok = bool((got[:, 1:1 + cap] == got[:, 1 + cap:].clamp(
            min=0)).all())
        check("queue_balance: counts within 1, items kept, payload along",
              int(counts.max() - counts.min()) <= 1
              and torch.equal(items, torch.sort(want).values) and pay_ok,
              f"counts {counts.tolist()}")
    ip, ix, v_att, e_att = walk_shards(load("indptr"), load("indices"), S, r)
    ip, ix = ip.to(dev), ix.to(dev)
    walks = run("walks", lambda: random_walks_distributed(
        ip, ix, v_att, e_att, np.arange(n), spec["steps"],
        spec["walk_key"], mesh, axis=AX))
    del ip, ix
    if r == 0:
        same = torch.equal(walks.cpu(), torch.from_numpy(load("walks",
                                                              False)))
        check(f"walks ({n} walkers x {spec['steps']} steps) vs the "
              f"structured phase's", same, "bit-equal" if same else
              "differs")
    del walks

    # -- distributed Louvain on the degree-balanced shards -----------------
    ctr = RouteByteCounter(S)
    ml, scores = run("multilevel", lambda: multilevel_distributed(
        fwd, att, w, counter=ctr))
    results["multilevel"] = dict(scores=list(scores),
                                 contract_bytes=ctr.total_bytes,
                                 contract_levels=ctr.levels)
    if r == 0:
        want_s = load("ml_scores", False).tolist()
        want = torch.from_numpy(load("ml", False))
        differ = float((ml.cpu() != want).float().mean())
        dq = abs(scores[-1] - want_s[-1]) if scores else float("inf")
        check("multilevel Q vs the structured phase's multilevel",
              dq <= 1e-5, f"scores {scores} vs {want_s}; |dQ| {dq!r}; "
              f"share of vertices whose label differs {differ!r}")

    # -- streaming: update_shards, then both repairs -----------------------
    fb = get_registry().counter("streaming.reshard_fallback")

    def csr_of(prefix, weighted=True):
        return csr_from_numpy(load(f"{prefix}_indptr", False),
                              load(f"{prefix}_indices", False),
                              load(f"{prefix}_values", False) if weighted
                              else None, n, n, device=dev)

    changed_s = load("changed_sources", False)
    changed_v = load("changed_vertices", False)

    def reshard(shard, new, a, changed):
        shards = np.unique(a.owner(torch.from_numpy(
            changed.astype(np.int64))).numpy())
        got = update_shards(shard, new, a, shards, w)
        return got if got is not None else shard_of(new, a, r)

    fb0 = fb.value
    csr_new, sym_new = csr_of("new"), csr_of("newsym", weighted=False)
    new_fwd, new_sym = run("update_shards", lambda: (
        reshard(fwd, csr_new, att, changed_s),
        reshard(sym, sym_new, att_s, changed_v)))
    del csr_new, sym_new
    results["update_shards"] = dict(fallbacks=fb.value - fb0,
                                    m=[fwd.edges_per_shard,
                                       new_fwd.edges_per_shard,
                                       sym.edges_per_shard,
                                       new_sym.edges_per_shard])
    gid, real = att.resident(r, "cpu")
    prev = torch.from_numpy(load("ref_bfs", False))[gid.clamp(max=n - 1)]
    lv = run("bfs repair", lambda: bfs_repair_distributed(
        new_fwd, att, prev.to(dev), changed_s, w))
    gid_s, _ = att_s.resident(r, "cpu")
    prev_cc = torch.from_numpy(load("ref_cc", False))[gid_s.clamp(max=n - 1)]
    cc = run("cc repair", lambda: cc_repair_distributed(
        new_sym, att_s, prev_cc.to(dev), changed_v, w))
    lv, cc = w.gather(lv), w.gather(cc)
    if r == 0:
        for name, got, a, want in (("bfs", lv, att, "repair_bfs"),
                                   ("cc", cc, att_s, "repair_cc")):
            same = torch.equal(unshard_vertex_array(got, a),
                               torch.from_numpy(load(want, False)))
            check(f"{name} repair after {spec['inserts']} inserts vs the "
                  f"structured phase's repair", same,
                  "bit-equal" if same else "differs")
    del lv, cc, new_fwd, new_sym, sym

    # -- update_shards within the padding: vertex v's out-edges rewired
    # (as many deleted as inserted), v the first row of shard 1 with edges:
    # shard 1 is rebuilt on its rank, every other rank keeps its shard
    ip_h = load("old_indptr", False)
    lo, c = att.shard_slice(1)
    v = lo + int(np.flatnonzero(np.diff(ip_h[lo:lo + c + 1]) > 0)[0])
    ix_h = load("old_indices", False)
    a, b = int(ip_h[v]), int(ip_h[v + 1])
    ix_h[a:b] = (ix_h[a:b] + 1) % n
    rewired = csr_from_numpy(ip_h, ix_h, load("old_values", False), n, n,
                             device=dev)
    del ip_h, ix_h
    fb0 = fb.value
    kept = run("update_shards in the padding", lambda: update_shards(
        fwd, rewired, att, [1], w))
    if r == 1:
        want = shard_of(rewired, att, 1)
        ok = all(torch.equal(getattr(kept, f), getattr(want, f))
                 for f in ("src", "dst", "val")) \
            and not torch.equal(kept.dst, fwd.dst)
    else:
        ok = kept is fwd
    ok = w.gather(torch.tensor([int(ok), fb.value - fb0], device=dev))
    if r == 0:
        check(f"update_shards of vertex {v}'s {b - a} rewired edges: "
              "shard 1 rebuilt as shard_of, the other ranks keep their "
              "shard objects, no fallback",
              bool((ok[:, 0] == 1).all() and (ok[:, 1] == 0).all()),
              f"per rank (ok, fallbacks) {ok.tolist()}")
    del kept, rewired

    # -- the service on the mesh, sync then async --------------------------
    csr = csr_of("old")
    srcs, tgts = spec["svc_sources"], spec["svc_targets"]
    for placement in ("sync", "async"):
        svc = run(f"service {placement} build", lambda: GraphService(
            csr, batch_budget=len(srcs), mesh=mesh, placement=placement))

        def serve():
            ts = [(svc.submit(kind(int(s), int(t))), kind, i, int(t))
                  for i, s in enumerate(srcs) for t in tgts[i]
                  for kind in (Reachability, Distance)]
            svc.flush()
            return [(kind, i, t, svc.result(k)) for k, kind, i, t in ts]

        answers = run(f"service {placement}", serve)
        adm = dict(svc.admission)

        def resubmit():
            return [svc.result(svc.submit(kind(int(srcs[i]), t),
                                          deadline=0.0))
                    for kind, i, t, _ in answers]

        again = run(f"service {placement} zero-deadline resubmits", resubmit)
        st = svc.stats
        results[f"service {placement}"] = dict(
            queries=st.queries, batches=st.batches,
            route_bytes=st.route_bytes, push_levels=st.push_levels,
            admission_serve=adm, admission_resubmits={
                k: svc.admission[k] - adm[k] for k in adm})
        if r == 0:
            n_adm = svc.admission["collectives"] - adm["collectives"]
            check(f"service {placement}: {len(again)} zero-deadline "
                  f"resubmits answered from the cache, one admission "
                  f"collective each", again == [a for *_, a in answers]
                  and n_adm == len(again), f"{n_adm} admission collectives")
        if r == 0:
            lv_b, d_b = load("ref_msbfs"), load("ref_sssp_batched")
            bad = [(kind.__name__, i, t) for kind, i, t, a in answers
                   if a != (bool(lv_b[i, t] >= 0) if kind is Reachability
                            else float(d_b[i, t]))]
            check(f"service {placement}: {len(answers)} answers vs phase 4's "
                  f"msbfs / sssp_batched", not bad,
                  f"differing {bad[:4]}")
        del svc

    # -- the (2, 2) grid: BFS over the tuple axis, hierarchical psum --------
    lv = run("grid bfs auto", lambda: bfs_distributed(
        fwd, att, 0, mesh, g_rev=rev, mode="auto", axis=AX))
    lv = w.gather(lv)
    x = torch.tensor([float(mesh.rank + 1)], device=dev)
    hp = offload.hierarchical_psum(x, AX, mesh)
    if r == 0:
        same = torch.equal(unshard_vertex_array(lv, att),
                           torch.from_numpy(load("ref_bfs", False)))
        check("(2, 2) grid bfs auto over ('data', 'model') vs the 1-D bfs",
              same and float(hp[0]) == S * (S + 1) / 2,
              f"bit-equal {same}; hierarchical psum {float(hp[0])!r}")
    mine = {"rank": r, "device": str(dev), "backend": mesh.backend,
            "load_s": load_s, "paths": paths, "results": results}
    if r == 0:
        mine["checks"] = checks
    return mine


def dist2_phase(g, kept: dict, ref: dict, smi: str) -> dict:
    """The second distributed phase: the structured phase's results and
    the graph after its inserts (and its symmetrization) saved beside the
    first distributed phase's shards, then DIST_RANKS ranks sharing the
    card over gloo, laid out as a (2, 2) grid, run every path of
    :func:`dist2_rank`.  Fails on any check."""
    import numpy as np
    from repro_torch.core.algorithms import symmetrize
    from repro_torch.core.graph import csr_from_numpy
    from repro_torch.launch import mesh as M

    t_phase = time.perf_counter()
    n = g.n_rows
    new = csr_from_numpy(kept["new_indptr"], kept["new_indices"],
                         kept["new_values"], n, n, device=g.device)
    sym = symmetrize(new)
    arrays = {"walks": kept["walks"], "ml": kept["ml"],
              "ml_scores": kept["ml_scores"],
              "repair_bfs": kept["repair_bfs"],
              "repair_cc": kept["repair_cc"],
              "changed_sources": kept["changed_sources"],
              "changed_vertices": kept["changed_vertices"],
              "old_indptr": g.indptr.cpu().numpy(),
              "old_indices": g.indices.cpu().numpy(),
              "old_values": g.values.cpu().numpy(),
              "new_indptr": kept["new_indptr"],
              "new_indices": kept["new_indices"],
              "new_values": kept["new_values"],
              "newsym_indptr": sym.indptr.cpu().numpy(),
              "newsym_indices": sym.indices.cpu().numpy()}
    for name, a in arrays.items():
        np.save(os.path.join(DIST_DIR, name + ".npy"), a)
    del new, sym, arrays
    prep_s = time.perf_counter() - t_phase
    srcs = [int(v) for v in ref["sources"][:DIST2_SVC_BUDGET]]
    rng = np.random.default_rng(1)
    tgts = [rng.integers(0, n, DIST2_SVC_TARGETS).tolist() for _ in srcs]
    # every source's BFS tree holds some of its targets
    lv_b = ref["msbfs"]
    for i in range(len(srcs)):
        tgts[i][0] = int(np.flatnonzero(lv_b[i] >= 0)[-1])
    cap = n // 2
    spec = dict(dir=DIST_DIR, n=n, steps=WALK_STEPS, walk_key=41,
                inserts=REPAIR_INSERTS, svc_sources=srcs, svc_targets=tgts,
                queue_cap=cap, queue_counts=[cap, 0, cap // 2, cap // 4])
    init = os.path.join(DIST_DIR, "init2")
    if os.path.exists(init):
        os.unlink(init)
    log(f"[dist2] card: {smi}")
    log(f"[dist2] host preparation (the structured phase's results, the "
        f"graph after its {REPAIR_INSERTS} inserts and its symmetrization, "
        f"saved): {prep_s!r} s")
    t0 = time.perf_counter()
    ranks = M.spawn(dist2_rank, DIST_RANKS, device="cuda", init_file=init,
                    args=(spec,), timeout=900,
                    grid=((2, 2), ("data", "model")),
                    coll_timeout=CHIP_COLL_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    rep = ranks[0]
    log(f"[dist2] {DIST_RANKS} ranks as a (2, 2) grid ('data', 'model') on "
        f"{[r['device'] for r in ranks]}, backend {rep['backend']}; spawn "
        f"to exit {ranks_s!r} s; loading the shards "
        f"{[round(r['load_s'], 3) for r in ranks]} s")
    launched = {"segment_or": 0, "segment_mode": 0, "run_sum": 0}
    for label, row in rep["paths"].items():
        walls = [r["paths"][label]["wall_s"] for r in ranks]
        inside = [sum(r["paths"][label]["seconds"].values()) for r in ranks]
        card = [sum(r["paths"][label]["card_seconds"].values())
                for r in ranks]
        launches = {k: sum(r["paths"][label]["launches"][k] for r in ranks)
                    for k in launched}
        for k in launched:
            launched[k] += launches[k]
        peak = [round(r["paths"][label]["peak_gib"], 3) for r in ranks]
        log(f"[dist2] {label}: wall {max(walls)!r} s (per rank {walls}); "
            f"collectives {row['collectives']} {row['calls']}, bytes per "
            f"rank {row['bytes']}; host seconds inside the collectives "
            f"{[round(i, 4) for i in inside]}, card seconds between their "
            f"events {[round(c, 4) for c in card]}; peak allocated per rank "
            f"{peak} GiB; launches over the ranks {launches}")
    for label, res in rep["results"].items():
        log(f"[dist2] {label}: {res}")
    checks = list(rep["checks"])
    checks.append(("segment_mode and segment_or launched",
                   launched["segment_mode"] + launched["run_sum"] > 0
                   and launched["segment_or"] > 0, f"{launched}"))
    for name, ok, detail in checks:
        log(f"[check] dist2 {name}: {'ok' if ok else 'FAILED'}; {detail}")
    phase_s = time.perf_counter() - t_phase
    log(f"[dist2] phase wall {phase_s!r} s (budget 120 s); cuts: the service "
        f"at batch_budget={DIST2_SVC_BUDGET} over phase 4's first "
        f"{DIST2_SVC_BUDGET} sources")
    failed = [c[0] for c in checks if not c[1]]
    if failed:
        fail(f"the second distributed phase failed: {failed}")
    return {"phase_s": phase_s, "prep_s": prep_s, "ranks_s": ranks_s,
            "launches": launched, "ranks": ranks}


# -- the training phase ------------------------------------------------------

TRAIN_SMOKE = ("qwen3-14b", "minicpm3-4b", "mixtral-8x7b", "gin-tu",
               "gatedgcn", "dimenet", "equiformer-v2", "fm")
TRAIN_LOSS_RTOL = 1e-4             # smoke step, card vs CPU
# gradients card vs CPU, relative to the model's largest gradient: f32 on
# both sides, summed in other orders (B4's atomics, cuBLAS); a lost path
# reads O(1)
TRAIN_GRAD_TOL = 1e-4
# parameters after the smoke step, card vs CPU, where both gradients pass
# TRAIN_GRAD_TOL of the scale or both are 0: Adam's first step moves a
# weight by lr * g / (|g| + eps), so a gradient within the card's rounding
# of 0 takes either sign, and there the card may differ by up to 2 lr
TRAIN_PARAM_TOL = 1e-4
# the smoke step's optimizer: no warmup, so step 1 moves each weight by
# about lr, ten times TRAIN_PARAM_TOL; a missing or wrong update fails
SMOKE_OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
GIN_SHAPE, GIN_DEGREE, GIN_STEPS = "ogb_products", 25, 4
GNN_ARCHS = ("gin-tu", "gatedgcn", "dimenet", "equiformer-v2")
MOL_GRAPHS, MOL_NODES, MOL_EDGES = 128, 30, 64     # molecule: per graph
LM_TRAIN_ARCH = "minicpm3-4b"      # the one LM whose training fits a card
LM_TRAIN_BATCH = 2                 # train_4k's batch 256, cut for memory
# 3 steps a run, the fewest that time two warm steps and see the loss fall
# past step 1, so the script keeps its time with phase 10
LM_TRAIN_STEPS = 3
# Adam's first step moves each weight by about its lr (lr g / (|g| + eps)).
# A bf16 weight |w| ~ 0.02 (std 1 / sqrt(2560)) has a spacing of 1.2e-4,
# so a smaller step rounds back to the old value: in bf16, step 1 at
# LM_TRAIN_LR must change at least LM_MOVED_MIN of the weights.  At that
# lr the first steps overshoot (the loss rises, then falls unevenly), so
# the falling loss is held on f32 weights at LM_FALL_LR, where every
# weight with a gradient moves; the moments are then bf16, which keeps the
# state at the bf16 run's 51 GB
LM_TRAIN_LR = 1e-4
LM_FALL_LR = 1e-5
LM_MOVED_MIN = 0.5
FT_STEPS, FT_EVERY, FT_FAILS = 12, 3, (4, 8)
TRAIN_DIR = os.path.join(ROOT, "build", "train_smoke")
B4_KERNELS = ("segment_sum",)
# torch's row gathers (index_select, advanced indexing, gather)
GATHER_KERNELS = ("index", "gather")
TOP_KERNELS = 8


def device_split(fn) -> dict:
    """fn's kernels under ``torch.profiler``: device ms in all, in B4 and
    in cuBLAS's matrix products; B4's kernels and all kernels; the
    top-level aten ops the host dispatched; the TOP_KERNELS kernel names
    that took the most device time, with their ms and counts.  Device
    times are None where the profiler recorded no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()

    def us(e):
        return e.device_time_total

    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    b4 = [e for e in kern if any(n in e.name for n in B4_KERNELS)]
    gathers = [e for e in kern if e not in b4 and any(
        n in e.name.lower() for n in GATHER_KERNELS)]
    total = sum(us(e) for e in kern)
    host_ops = sum(1 for e in events if e.device_type == DeviceType.CPU and
                   e.cpu_parent is None and e.name.startswith("aten::"))
    out = dict(kernels=len(kern), b4_kernels=len(b4),
               gather_kernels=len(gathers), host_ops=host_ops,
               device_ms=None, b4_ms=None, matmul_ms=None, gather_ms=None,
               top=[])
    by_name: dict = {}
    for e in kern:
        ms, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + us(e) / 1e3, cnt + 1)
    out["top"] = [(name[:80], ms, cnt) for name, (ms, cnt) in sorted(
        by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]]
    if total > 0:
        out.update(device_ms=total / 1e3,
                   b4_ms=sum(us(e) for e in b4) / 1e3,
                   gather_ms=sum(us(e) for e in gathers) / 1e3,
                   matmul_ms=sum(us(e) for e in kern if any(
                       n in e.name.lower() for n in MATMUL_KERNELS)) / 1e3)
    return out


def b4_bound_ms(n_rows: int, d: int, n: int) -> float:
    """B4's byte bound (``kernels.cost.segment_sum_bytes``): data (or the
    gathered rows) and the ids read once, out written once."""
    from repro_torch.kernels import cost
    return least_ms(cost.segment_sum_bytes(n_rows, d, n))[0]


def b4_strict_bound_ms(t_rows: int, n_rows: int, d: int, n: int) -> float:
    """B4's strict byte bound with the row gather fused in
    (``kernels.cost.segment_sum_strict_bytes``): the table read once (only
    an L2 that held it whole would come near), the ids and the offsets
    read once, out written once."""
    from repro_torch.kernels import cost
    return least_ms(cost.segment_sum_strict_bytes(t_rows, n_rows, d, n))[0]


def b4_block_n(n: int) -> int:
    """The block_n B4's entry resolves for n segments on the card."""
    import torch
    from repro_torch import tune
    return int(tune.resolve("kernels.segment_sum.block_n", None, n=n,
                            device=torch.device("cuda")))


def b4_sweep(call, reps: int) -> dict:
    """B4's kernel time at each block_n of B4_BLOCK_NS: ``call(block_n)``
    launches it (the choice of the tuned default)."""
    return {bn: cuda_ms(lambda: call(bn), reps) for bn in B4_BLOCK_NS}


def csr_adjacency(offsets, rows, t_rows: int):
    """The (M, T) CSR matrix of ones whose product with a (T, d) table is
    B4 on (offsets, rows): ``torch.sparse.mm``'s yardstick (cuSPARSE
    SpMM), timed only; an id outside [0, T) gets a 0."""
    import torch
    lo, hi = int(offsets[0]), int(offsets[-1])
    ids = torch.arange(lo, hi, device=offsets.device) if rows is None \
        else rows[lo:hi].long()
    ok = (ids >= 0) & (ids < t_rows)
    return torch.sparse_csr_tensor(offsets - lo, ids.clamp(0, t_rows - 1),
                                   ok.float(),
                                   size=(offsets.numel() - 1, t_rows))


def b4_repro(label, out, offsets, table, rows, want, again):
    """The ``[repro]`` line of B4: a second launch on the same inputs
    (``again()``) gives out's bits, which are the bits of the kernel's
    order (``ref.segment_sum_pieces_ref``); and a planted fault, the
    longest row's largest entry dropped, fails the SEG_TOL check."""
    import torch
    from repro_torch.kernels import ops, ref
    bn = b4_block_n(offsets.numel() - 1)
    same = bool(torch.equal(again(), out))
    mirror = bool(torch.equal(ref.segment_sum_pieces_ref(
        table, offsets, rows, block_n=bn), out))
    hub = int(torch.argmax(offsets[1:] - offsets[:-1]))
    lo, hi = int(offsets[hub]), int(offsets[hub + 1])
    ids = torch.arange(lo, hi, device=table.device) if rows is None \
        else rows[lo:hi].long()
    faulty = torch.arange(table.shape[0], dtype=torch.int32,
                          device=table.device) if rows is None \
        else rows.clone()
    faulty[lo + int(torch.argmax(table[ids].abs().amax(1)))] = -1
    bad = ops.segment_sum_csr(table, offsets, faulty)
    caught = not bool(torch.allclose(bad, want, rtol=SEG_TOL, atol=SEG_TOL))
    log(f"[repro] {label}: two launches bit-equal: {same}; equal to the "
        f"kernel order's mirror (block_n {bn}): {mirror}; a planted fault "
        f"(row {hub}'s {hi - lo} entries less its largest) fails the "
        f"check: {caught}")
    if not (same and mirror and caught):
        fail(f"{label}: B4 is not reproducible, not in its order, or the "
             f"check passes a fault")


def step_peak(fn, arg_bytes: int) -> dict:
    """fn()'s peak allocated bytes on the card as one step's own: the
    peak less the bytes held before it, plus those of its arguments
    (``arg_bytes``, held before it too), so memory held for other work is
    left out; phase 11 holds the dry run's peak to it."""
    import torch
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del res
    return {"peak": peak, "held": held, "args": arg_bytes,
            "step_peak": peak - held + arg_bytes}


def gin_graph():
    """gin-tu's ogb_products cell: its spec bundle, and the edges of
    ``uniform_random_graph(n, GIN_DEGREE, seed=0)`` on the card as int32
    (src, dst) in CSR order, padded with -1 to the cell's edge count;
    the count of real edges."""
    import torch
    from repro_torch.configs import get_config, input_specs
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.core.graph import uniform_random_graph
    bundle = input_specs(get_config("gin-tu"), GIN_SHAPE)
    e_pad = bundle.batch["src"].shape[0]
    g = uniform_random_graph(GNN_SHAPES[GIN_SHAPE]["n"], GIN_DEGREE, seed=0,
                             device="cuda")
    src, dst = g.row_ids().to(torch.int32), g.indices.to(torch.int32)
    e_real = src.numel()
    if e_real > e_pad:
        fail(f"gin-tu graph has {e_real} edges, more than the cell's {e_pad}")
    pad = torch.full((e_pad - e_real,), -1, dtype=torch.int32, device="cuda")
    return bundle, torch.cat([src, pad]), torch.cat([dst, pad]), e_real


def b4_gin_cases(args, gen, called, held) -> list:
    """Phase 6's gin-tu cases of B4 at ogb_products' widths: GIN's fused
    gather-and-sum forward at d 100 (layer 0) and d 64, and its backward at
    d 64, on one EdgePlan of the cell's edges, each held to its plain
    version (the d 64 forward also to its order's mirror and twice for its
    bits) and timed beside both bounds, the plain version, torch.sparse.mm
    on the same CSR of ones and, for the unfused form, index_add_ of the
    (E, d) messages the port no longer writes."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import segment_sum as SS
    from repro_torch.models import gnn as G
    t0 = time.perf_counter()
    bundle, src, dst, e_real = gin_graph()
    n = bundle.batch["x"].shape[0]
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0

    def build():
        p = G.EdgePlan(src, dst, n, n)
        p.form("dst")
        p.form("src")
        return p
    plan_ms = cuda_ms(build, 2, 1)
    plan = build()
    log(f"[time] B4 gin-tu {GIN_SHAPE}: graph {graph_s!r} s; an EdgePlan "
        f"of its {src.numel()} edges (both forms: one stable sort of the "
        f"destinations, the sources already in order) {plan_ms!r} ms")
    mdst = plan.dst
    cases = []
    for name, d, by in (("fused forward, d 100", 100, "dst"),
                        ("fused forward, d 64", 64, "dst"),
                        ("fused backward, d 64", 64, "src")):
        offsets, rows = plan.form(by)
        table = torch.randn(n, d, device="cuda", generator=gen)
        label = f"B4 gin-tu {GIN_SHAPE} {name}"
        got, cnt = called(SS, "segment_sum", lambda: ops.segment_sum_csr(
            table, offsets, rows))
        want = ref.segment_sum_csr_ref(table, offsets, rows)
        err = held("segment_sum", label, got, want, SEG_TOL)
        if name == "fused forward, d 64":
            b4_repro(label, got, offsets, table, rows, want,
                     lambda: ops.segment_sum_csr(table, offsets, rows))
        del got, want
        e = int(offsets[-1] - offsets[0])
        adj = csr_adjacency(offsets, rows, n)
        case = dict(
            shape=label, launches=cnt, max_abs_err=err,
            ms=cuda_ms(lambda: ops.segment_sum_csr(table, offsets, rows),
                       args.reps),
            plain_ms=cuda_ms(lambda: ref.segment_sum_csr_ref(
                table, offsets, rows), 2, 1),
            bound_ms=b4_bound_ms(e, d, n),
            strict_bound_ms=b4_strict_bound_ms(n, e, d, n), bound_by="bytes",
            library_ms=cuda_ms(lambda: torch.sparse.mm(adj, table), 3, 1),
            plan_ms=plan_ms, split_rows=SS.split_rows(offsets, b4_block_n(n)))
        if name == "fused forward, d 64":
            case["block_n_ms"] = b4_sweep(lambda bn: ops.segment_sum_csr(
                table, offsets, rows, block_n=bn), args.reps)
        del adj
        # the unfused form: the (E, d) messages, then index_add_ of them
        ids, key = (src, mdst) if by == "dst" else (mdst, src)
        msg = table[ids.clamp(min=0).long()].masked_fill_((ids < 0)[:, None],
                                                          0)
        safe = torch.where((key >= 0) & (key < n), key, n).long()
        acc = torch.zeros(n + 1, d, device="cuda")
        case["index_add_ms"] = cuda_ms(lambda: acc.index_add_(0, safe, msg),
                                       3, 1)
        del msg, safe, acc, table
        torch.cuda.empty_cache()
        log(f"[time] segment_sum {label}: kernel {case['ms']!r} ms, plain "
            f"{case['plain_ms']!r} ms, bound {case['bound_ms']!r} ms "
            f"(strict {case['strict_bound_ms']!r}), torch.sparse.mm "
            f"{case['library_ms']!r} ms, index_add_ of the messages "
            f"{case['index_add_ms']!r} ms; {case['split_rows']} rows split"
            + (f"; by block_n {case['block_n_ms']}" if "block_n_ms" in case
               else ""))
        cases.append(case)
    return cases


def _smoke_batch(ac, cfg) -> dict:
    """The smoke batch of tests/test_arch_smoke.py's shapes, as CPU
    tensors."""
    import numpy as np
    import torch
    from repro_torch.core.graph import uniform_random_graph
    from repro_torch.data import synthetic
    rng = np.random.default_rng(0)
    if ac.family == "lm":
        b = {"tokens": rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)}
    elif ac.family == "recsys":
        b = next(synthetic.recsys_batches(16, cfg.n_fields,
                                          cfg.rows_per_field))
    else:
        g = uniform_random_graph(48, 3, seed=1, device="cpu")
        b = synthetic.gnn_batch(cfg.arch, g, cfg.d_feat, cfg.n_classes,
                                l_max=cfg.l_max)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _params_to(params, dev):
    """A copy of parameters (a module or a tree) on dev."""
    import copy
    import torch
    if isinstance(params, torch.nn.Module):
        return copy.deepcopy(params).to(dev)
    if isinstance(params, dict):
        return {k: _params_to(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [_params_to(v, dev) for v in params]
    return params.detach().clone().to(dev)


def _molecule_batch(cfg, spec: dict) -> dict:
    """The molecule cell's batch on the card: MOL_GRAPHS graphs of
    MOL_NODES atoms and MOL_EDGES random bonds each, a regression target
    per graph, the node table padded to the cell's size (padded nodes
    masked out of the readout); DimeNet's triplets and EquiformerV2's
    Wigner rotations from the synthetic pipeline.  Fails unless it matches
    the cell's specs."""
    import numpy as np
    import torch
    from repro_torch.data import synthetic
    rng = np.random.default_rng(0)
    n, e = MOL_GRAPHS * MOL_NODES, MOL_GRAPHS * MOL_EDGES
    n_pad = spec["x"].shape[0]
    base = np.repeat(np.arange(MOL_GRAPHS) * MOL_NODES, MOL_EDGES)
    src = (base + rng.integers(0, MOL_NODES, e)).astype(np.int32)
    dst = (base + rng.integers(0, MOL_NODES, e)).astype(np.int32)
    gid = np.zeros(n_pad, np.int32)
    gid[:n] = np.repeat(np.arange(MOL_GRAPHS), MOL_NODES)
    b = {"x": rng.standard_normal((n_pad, cfg.d_feat)).astype(np.float32),
         "src": src, "dst": dst,
         "labels": rng.standard_normal(MOL_GRAPHS).astype(np.float32),
         "graph_id": gid, "node_mask": np.arange(n_pad) < n,
         "pos": rng.standard_normal((n_pad, 3)).astype(np.float32) * 3.0}
    if cfg.arch == "dimenet":
        t_kj, t_ji, ang = synthetic.build_triplets(
            src, dst, b["pos"], spec["triplet_kj"].shape[0])
        b.update(triplet_kj=t_kj, triplet_ji=t_ji, angle=ang)
    if cfg.arch == "equiformer_v2":
        b["wigner"] = synthetic.build_wigner(src, dst, b["pos"], cfg.l_max)
    b = {k: torch.from_numpy(v) for k, v in b.items() if k in spec}
    for k, s in spec.items():
        if k not in b or tuple(b[k].shape) != tuple(s.shape) or \
                b[k].dtype != s.dtype:
            fail(f"molecule batch {k} does not match the cell's spec "
                 f"{tuple(s.shape)} {s.dtype}")
    return {k: v.cuda() for k, v in b.items()}


def train_phase(args, smi: str) -> dict:
    """The training phase (``[train]`` and ``[check] train`` lines): one
    ``make_step`` train step of each smoke config on the card and on the
    CPU from the same parameters and batch (loss, gradients, parameters
    after the step), no B6 launch in a train step and B6 once a layer on
    prefill; gin-tu at its published widths on the ogb_products cell's
    shape for GIN_STEPS steps on one batch (B4 launches per step, every B4
    call of step 1 against its plain version, B4's device time a step,
    each kind of B4 call beside ``index_add_`` on the same inputs); the
    four GNNs at their published widths on the molecule cell; minicpm3-4b
    at its published widths on train_4k's sequence, in bf16 and with f32
    weights; a checkpoint round trip and a restart after two failures; the
    train CLI.  Returns the
    phase's numbers; fails on any check."""
    import dataclasses
    import itertools
    import shutil
    from unittest import mock

    import torch
    from repro_torch.checkpoint import ckpt as CK
    from repro_torch.configs import get_config, input_specs
    from repro_torch.configs.common import (GNN_SHAPES, SpecBundle,
                                            init_params, make_step)
    from repro_torch.data import synthetic
    from repro_torch.distributed.fault_tolerance import (
        FTConfig, SimulatedFailure, run_training)
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import segment_sum as SS
    from repro_torch.launch.mesh import HW
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    rules = make_rules(None)
    out = {"nvidia_smi": smi, "smoke": {}, "molecule": {}}
    b4_main = 0                       # B4 launches on the training path
    fast = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=30,
                             weight_decay=0.0)

    def counted_step(step, state, batch):
        """One step with B4's and B6's counts zeroed before it and read
        after it; returns (state, metrics, wall s, B4, B6)."""
        SS.reset_launches()
        FA.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        return (state, m, time.perf_counter() - t0,
                SS.LAUNCHES["segment_sum"], FA.LAUNCHES["flash_attention"])

    # -- card vs CPU, smoke configs ------------------------------------------
    for arch in TRAIN_SMOKE:
        ac = get_config(arch)
        cfg = ac.smoke
        p_cpu = init_params(ac, cfg, 0, device="cpu")
        batch = _smoke_batch(ac, cfg)
        step = make_step(ac, SpecBundle("train", cfg, {}, {}), rules,
                         adamw.AdamWConfig(**SMOKE_OPT))
        got = {}
        for dev, params in (("cpu", p_cpu),
                            ("cuda", _params_to(p_cpu, "cuda"))):
            st = adamw.init_state_with_dtype(params, ac.moment_dtype)
            st, m, _, b4, b6 = counted_step(step, st, batch)
            named = adamw.named_params(st.params)
            got[dev] = dict(
                loss=float(m["loss"]), b4=b4, b6=b6,
                grads={k: None if p.grad is None else p.grad.float().cpu()
                       for k, p in named.items()},
                params={k: p.detach().float().cpu()
                        for k, p in named.items()})
        c, g = got["cpu"], got["cuda"]
        b4_main += g["b4"]
        rel = abs(g["loss"] - c["loss"]) / max(abs(c["loss"]), 1e-12)
        scale = max(float(v.abs().max()) for v in c["grads"].values())
        bad = [k for k, v in g["grads"].items()
               if v is None or not bool(torch.isfinite(v).all())
               or (bool((c["grads"][k] != 0).any())
                   and not bool((v != 0).any()))]
        gerr = max(float((g["grads"][k] - c["grads"][k]).abs().max())
                   for k in c["grads"] if k not in bad) / scale
        perr = prest = 0.0
        n_dec = n_all = 0
        for k, want in c["params"].items():
            diff = (g["params"][k] - want).abs()
            gc, gg = c["grads"][k], g["grads"][k]
            if gc is None or gg is None:
                dec = torch.ones_like(diff, dtype=torch.bool)
            else:
                t = TRAIN_GRAD_TOL * scale
                dec = ((gc.abs() > t) & (gg.abs() > t)) | \
                    ((gc == 0) & (gg == 0))
            n_dec += int(dec.sum())
            n_all += dec.numel()
            perr = max(perr, float(torch.where(dec, diff, 0).max()))
            prest = max(prest, float(torch.where(dec, 0, diff).max()))
        share = n_dec / n_all
        lr = SMOKE_OPT["lr"]
        log(f"[train] smoke {arch}: loss card {g['loss']!r} cpu "
            f"{c['loss']!r} (rel {rel!r}); {len(c['grads'])} parameters, "
            f"gradient max |card - cpu| / max |grad| {gerr!r}; parameters "
            f"after the step (lr {lr}) max |card - cpu| {perr!r} over "
            f"{share:.4f} of {n_all} weights, {prest!r} over the rest "
            f"(gradient within {TRAIN_GRAD_TOL} of the scale); launches B4 "
            f"{g['b4']} B6 {g['b6']}")
        if rel > TRAIN_LOSS_RTOL or bad or gerr > TRAIN_GRAD_TOL or \
                perr > TRAIN_PARAM_TOL or share < 0.5 or \
                prest > 2 * lr + TRAIN_PARAM_TOL:
            fail(f"train smoke {arch}: card disagrees with the CPU (loss rel "
                 f"{rel}, gradients missing / non-finite / zero {bad[:4]}, "
                 f"gradient {gerr}, parameters {perr} over {share} of the "
                 f"weights, {prest} over the rest)")
        if ac.family == "lm" and g["b6"] != 0:
            fail(f"train smoke {arch}: a train step launched B6 "
                 f"{g['b6']} times (B6 has no backward)")
        if ac.family == "gnn" and g["b4"] == 0:
            fail(f"train smoke {arch}: the train step did not launch B4")
        out["smoke"][arch] = dict(loss_rel=rel, grad_err=gerr,
                                  param_err=perr, param_share=share,
                                  param_err_rest=prest, b4=g["b4"],
                                  b6=g["b6"])
    ac = get_config("qwen3-14b")
    model = init_params(ac, ac.smoke, 0, device="cuda")
    FA.reset_launches()
    TF.prefill(ac.smoke, model, _smoke_batch(ac, ac.smoke)["tokens"].cuda())
    torch.cuda.synchronize()
    out["b6_prefill"] = FA.LAUNCHES["flash_attention"]
    log(f"[check] train: B6 launches in the LM smoke train steps "
        f"{[out['smoke'][a]['b6'] for a in TRAIN_SMOKE[:3]]} (want 0); in "
        f"qwen3 smoke prefill {out['b6_prefill']} (want "
        f"{ac.smoke.n_layers}, one a layer)")
    if out["b6_prefill"] != ac.smoke.n_layers:
        fail("prefill no longer launches B6 once a layer")
    del model

    # -- gin-tu at its published widths, ogb_products ------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ac = get_config("gin-tu")
    t0 = time.perf_counter()
    bundle, src, dst, e_real = gin_graph()
    cfg, spec = bundle.model, bundle.batch
    n_real = GNN_SHAPES[GIN_SHAPE]["n"]
    (n_pad, n_feat), e_pad = spec["x"].shape, spec["src"].shape[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"x": torch.randn(n_pad, n_feat, generator=gen, device="cuda"),
             "src": src, "dst": dst,
             "labels": torch.randint(0, cfg.n_classes, (n_pad,),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32),
             "label_mask": torch.arange(n_pad, device="cuda") < n_real}
    del src, dst
    for k, s in spec.items():
        if tuple(batch[k].shape) != tuple(s.shape) or \
                batch[k].dtype != s.dtype:
            fail(f"gin-tu batch {k} does not match the cell's spec")
    torch.cuda.synchronize()
    log(f"[train] gin-tu {GIN_SHAPE}: n {n_real} (padded {n_pad}), e "
        f"{e_real} (padded {e_pad}), d_feat {n_feat}, {cfg.n_classes} "
        f"classes, {cfg.n_layers} layers, d {cfg.d_hidden}; graph and batch "
        f"in {time.perf_counter() - t0!r} s")
    state = adamw.init_state(init_params(ac, cfg, 0, device="cuda"))
    step = make_step(ac, bundle, rules, fast)
    orig = ops.segment_sum_csr
    calls, kinds, first = [], {}, []

    def checked(table, offsets, rows=None, **kw):
        """B4 as the step calls it, then held to its plain version; the
        first call of each kind (width; edges grouped by destination, the
        forward, or by source, the backward) also timed beside
        ``torch.sparse.mm`` on the same CSR of ones.  The launches made to
        check or time are taken back out of the count."""
        got = orig(table, offsets, rows, **kw)
        kept = SS.LAUNCHES["segment_sum"]
        want = ref.segment_sum_csr_ref(table, offsets, rows)
        d = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=SEG_TOL, atol=SEG_TOL))
        del want
        # the step's first B4 call is layer 0's forward, by destination
        first[:] = first or [offsets.data_ptr()]
        by = "destination (forward)" if offsets.data_ptr() == first[0] \
            else "source (backward)"
        kind = f"d {table.shape[1]}, by {by}"
        calls.append(dict(rows=table.shape[0], d=table.shape[1], kind=kind,
                          err=d, ok=ok))
        if kind not in kinds:
            m, e = offsets.numel() - 1, int(offsets[-1] - offsets[0])
            adj = csr_adjacency(offsets, rows, table.shape[0])
            kinds[kind] = dict(
                ms=cuda_ms(lambda: orig(table, offsets, rows, **kw), 3, 1),
                library_ms=cuda_ms(lambda: torch.sparse.mm(adj, table), 3,
                                   1),
                bound_ms=b4_bound_ms(e, table.shape[1], m),
                strict_bound_ms=b4_strict_bound_ms(table.shape[0], e,
                                                   table.shape[1], m))
            del adj
        SS.LAUNCHES["segment_sum"] = kept
        return got

    gin = {"losses": [], "walls": [], "b4": []}
    for i in range(GIN_STEPS):
        if i == 0:
            with mock.patch.object(ops, "segment_sum_csr", checked):
                state, m, wall, b4, _ = counted_step(step, state, batch)
        elif i == GIN_STEPS - 1:
            res = {}
            SS.reset_launches()
            t0 = time.perf_counter()
            gin["profile"] = device_split(
                lambda: res.update(out=step(state, batch)))
            wall, b4 = time.perf_counter() - t0, SS.LAUNCHES["segment_sum"]
            state, m = res["out"]
        else:
            state, m, wall, b4, _ = counted_step(step, state, batch)
        gin["losses"].append(float(m["loss"]))
        gin["walls"].append(wall)
        gin["b4"].append(b4)
    b4_main += sum(gin["b4"])
    gin["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    gin["kinds"], gin["calls"] = kinds, calls
    # a step's B4 calls at their kind's kernel, torch.sparse.mm and bound
    # times
    for key in ("ms", "library_ms", "bound_ms", "strict_bound_ms"):
        gin[f"b4_{key}_per_step"] = sum(kinds[c["kind"]][key] for c in calls)
    # per layer: the forward's segment sum, its recompute, the gather's
    # backward; layer 0 gathers the input features, which take no gradient
    gin["b4_per_step_want"] = 3 * cfg.n_layers - 1
    worst = max(c["err"] for c in calls)
    log(f"[train] gin-tu losses {gin['losses']}; step walls {gin['walls']} "
        f"s (step 1 with the B4 checks and timings, step "
        f"{GIN_STEPS} under the profiler); peak "
        f"{gin['peak_gib']:.2f} GiB")
    log(f"[train] gin-tu B4 launches per step {gin['b4']} (want "
        f"{gin['b4_per_step_want']}: per layer the forward's segment sum, "
        f"its recompute and the gather's backward, less layer 0's gather "
        f"of the input features)")
    for kind, t in kinds.items():
        log(f"[time] gin-tu B4 {kind}: kernel {t['ms']!r} ms, bound "
            f"{t['bound_ms']!r} ms (strict {t['strict_bound_ms']!r}), "
            f"torch.sparse.mm {t['library_ms']!r} ms")
    log(f"[time] gin-tu a step's {len(calls)} B4 calls: kernel "
        f"{gin['b4_ms_per_step']!r} ms, bound {gin['b4_bound_ms_per_step']!r}"
        f" ms (strict {gin['b4_strict_bound_ms_per_step']!r}), "
        f"torch.sparse.mm {gin['b4_library_ms_per_step']!r} ms")
    p = gin["profile"]
    # an (E, d) message, however many launches write it, takes at least
    # its bytes over the memory rate: the step's gathers must take less
    gin["message_write_ms"] = least_ms(4 * e_pad * cfg.d_hidden)[0]
    log(f"[train] gin-tu step {GIN_STEPS} profiled: device {p['device_ms']!r}"
        f" ms, B4 {p['b4_ms']!r} ms over {p['b4_kernels']} kernels, matrix "
        f"products {p['matmul_ms']!r} ms, gathers {p['gather_ms']!r} ms over "
        f"{p['gather_kernels']} kernels, {p['kernels']} kernels, "
        f"{p['host_ops']} top-level aten ops")
    for name, ms, cnt in p["top"]:
        log(f"[train]   {ms!r} ms in {cnt} x {name}")
    log(f"[check] train gin-tu: {len(calls)} B4 calls of step 1 held to the "
        f"plain version (rtol / atol {SEG_TOL}), largest |kernel - plain| "
        f"{worst!r}")
    if not all(c["ok"] for c in calls) or \
            len(calls) != gin["b4_per_step_want"]:
        fail(f"gin-tu: B4 calls of step 1 disagree with the plain version "
             f"or miss: {calls}")
    if any(b != gin["b4_per_step_want"] for b in gin["b4"]):
        fail(f"gin-tu: B4 launches per step {gin['b4']}")
    if not gin["losses"][-1] < gin["losses"][0]:
        fail(f"gin-tu: the loss did not fall: {gin['losses']}")
    log(f"[check] train gin-tu: the profiled step's gather kernels take "
        f"{p['gather_ms']!r} ms in all, under the {gin['message_write_ms']!r}"
        f" ms one ({e_pad}, {cfg.d_hidden}) f32 message takes to write: "
        f"no (E, d) message is gathered")
    if p["gather_ms"] is None or p["gather_ms"] >= gin["message_write_ms"]:
        fail("gin-tu: the step still gathers (E, d) messages")
    # one more warm step, its own peak kept for phase 11's dry run
    from repro_torch.launch.dryrun import storage_bytes
    gin["step_peak"] = step_peak(lambda: step(state, batch),
                                 storage_bytes((state, batch)))
    log(f"[train] gin-tu one more warm step: its own peak "
        f"{gin['step_peak']['step_peak']} B ({gin['step_peak']})")
    out["gin"] = gin
    del state, step, batch
    torch.cuda.empty_cache()

    # -- the four GNNs at their published widths, molecule ------------------
    for arch in GNN_ARCHS:
        torch.cuda.reset_peak_memory_stats()
        ac = get_config(arch)
        bundle = input_specs(ac, "molecule")
        batch = _molecule_batch(bundle.model, bundle.batch)
        state = adamw.init_state(init_params(ac, bundle.model, 0,
                                             device="cuda"))
        step = make_step(ac, bundle, rules, fast)
        state, m, wall, b4, _ = counted_step(step, state, batch)
        b4_main += b4
        named = adamw.named_params(state.params)
        bad = [k for k, p in named.items()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        loss = float(m["loss"])
        # a second step, warm: the first pays each kernel's first load
        state, _, warm, b4_warm, _ = counted_step(step, state, batch)
        b4_main += b4_warm
        row = dict(loss=loss, wall_s=wall, warm_wall_s=warm, b4=b4,
                   params=sum(p.numel() for p in named.values()),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        out["molecule"][arch] = row
        log(f"[train] molecule {arch}: {row['params']} parameters, loss "
            f"{loss!r}, step {wall!r} s (a second step {warm!r} s), B4 "
            f"launches {b4} ({b4_warm}), peak {row['peak_gib']:.2f} GiB")
        if not math.isfinite(loss) or bad or b4 == 0 or b4_warm != b4:
            fail(f"molecule {arch}: loss {loss}, bad gradients {bad[:4]}, "
                 f"B4 launches {b4} then {b4_warm}")
        del state, step, batch
        torch.cuda.empty_cache()

    # -- minicpm3-4b at its published widths, train_4k's sequence ------------
    ac = get_config(LM_TRAIN_ARCH)
    bundle = input_specs(ac, "train_4k")
    cfg = bundle.model
    seq = bundle.batch["tokens"].shape[1]
    tokens = torch.from_numpy(next(synthetic.lm_batches(
        LM_TRAIN_BATCH, seq, cfg.vocab, seed=0))["tokens"]).cuda()
    tok = LM_TRAIN_BATCH * seq

    def lm_run(tag, dtype, moments, lr):
        """LM_TRAIN_STEPS steps from seed 0 with the weights in ``dtype``
        and the moments in ``moments``, at ``lr`` with no warmup: losses,
        walls, B6 launches and peak memory; fails unless every parameter
        has a finite nonzero gradient at step 1 and step 1 changed at
        least LM_MOVED_MIN of the weights."""
        torch.cuda.reset_peak_memory_stats()
        run_cfg = dataclasses.replace(cfg, dtype=dtype)
        t0 = time.perf_counter()
        model = init_params(ac, run_cfg, 0, device="cuda")
        state = adamw.init_state_with_dtype(model, moments)
        torch.cuda.synchronize()
        run = {"dtype": str(dtype), "moments": str(moments), "lr": lr,
               "params": TF.count_params(model),
               "init_s": time.perf_counter() - t0, "losses": [],
               "walls": [], "b6": []}
        step = make_step(ac, dataclasses.replace(bundle, model=run_cfg),
                         rules, adamw.AdamWConfig(
                             lr=lr, warmup_steps=0, total_steps=30,
                             weight_decay=0.0))
        named = adamw.named_params(state.params)
        # the weights before step 1, on the host: a step smaller than half
        # a weight's spacing leaves it as it was
        before = {k: p.detach().to("cpu", copy=True)
                  for k, p in named.items()}
        for i in range(LM_TRAIN_STEPS):
            state, m, wall, _, b6 = counted_step(step, state,
                                                 {"tokens": tokens})
            run["losses"].append(float(m["loss"]))
            run["walls"].append(wall)
            run["b6"].append(b6)
            if i:
                continue
            bad = [k for k, p in named.items() if p.grad is None
                   or not bool(torch.isfinite(p.grad).all())
                   or not bool((p.grad != 0).any())]
            run["grads_checked"] = len(named)
            if bad:
                fail(f"{LM_TRAIN_ARCH} {tag}: parameters without a finite "
                     f"nonzero gradient: {len(bad)}, e.g. {bad[:4]}")
            moved = sum(int((named[k].detach() != w.cuda()).sum())
                        for k, w in before.items())
            run["share_moved"] = moved / sum(w.numel()
                                             for w in before.values())
            del before
        run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"[train] {LM_TRAIN_ARCH} {tag} (weights {dtype}, moments "
            f"{moments}), lr {lr} with no warmup: {run['params']} "
            f"parameters, batch {LM_TRAIN_BATCH} x {seq}, init "
            f"{run['init_s']!r} s; step 1 changed {run['share_moved']!r} of "
            f"the weights (want at least {LM_MOVED_MIN}); losses "
            f"{run['losses']}; step walls {run['walls']} s; B6 launches "
            f"{run['b6']}; peak {run['peak_gib']:.2f} GiB")
        if any(run["b6"]):
            fail(f"{LM_TRAIN_ARCH} {tag}: a train step launched B6")
        if run["share_moved"] < LM_MOVED_MIN:
            fail(f"{LM_TRAIN_ARCH} {tag}: step 1 left most weights as they "
                 f"were ({run['share_moved']} changed)")
        del state, model, named, step
        torch.cuda.empty_cache()
        return run

    # the published dtype: the timings and the gradients
    lm = lm_run("bf16", cfg.dtype, ac.moment_dtype, LM_TRAIN_LR)
    lm.update(arch=LM_TRAIN_ARCH, batch=LM_TRAIN_BATCH, seq=seq,
              flops_step=6 * lm["params"] * tok,
              flops_step_remat=8 * lm["params"] * tok)
    warm = min(lm["walls"][1:])
    lm["tokens_per_s"] = tok / warm
    lm["tflops_achieved"] = lm["flops_step"] / warm / 1e12
    lm["bound_s"] = least_ms(0, lm["flops_step_remat"])[0] / 1e3
    log(f"[train] {LM_TRAIN_ARCH} bf16: {lm['tokens_per_s']!r} tokens/s "
        f"warm; 6ND {lm['flops_step']:.3e} FLOP a step "
        f"({lm['tflops_achieved']!r} TFLOP/s), 8ND with the recompute "
        f"{lm['flops_step_remat']:.3e} (bound {lm['bound_s']!r} s at "
        f"{HW['peak_bf16_flops']:.3g})")
    # f32 weights, bf16 moments (the same 51 GB of state): the falling loss
    lm["f32"] = lm_run("f32 weights", torch.float32, torch.bfloat16,
                       LM_FALL_LR)
    losses = lm["f32"]["losses"]
    log(f"[check] train {LM_TRAIN_ARCH}: with f32 weights at lr "
        f"{LM_FALL_LR} the loss went {losses[0]!r} -> {losses[-1]!r}; "
        f"step 1 changed {lm['f32']['share_moved']!r} of the weights; every "
        f"parameter had a finite nonzero gradient in both runs")
    if not losses[-1] < losses[0]:
        fail(f"{LM_TRAIN_ARCH}: the loss did not fall: {losses}")
    # one layer's autograd attention, forward and backward, at this shape
    m_ = cfg.mla
    H, qd = cfg.n_heads, m_.nope_head_dim + m_.rope_head_dim
    q = torch.randn(LM_TRAIN_BATCH, H, seq, qd, device="cuda",
                    dtype=cfg.dtype, requires_grad=True)
    k = torch.randn_like(q, requires_grad=True)
    v = torch.randn(LM_TRAIN_BATCH, H, seq, m_.v_head_dim, device="cuda",
                    dtype=cfg.dtype, requires_grad=True)
    lm["attn_fwd_ms"] = cuda_ms(lambda: TF.flash_attn(
        q.detach(), k.detach(), v.detach(), k_chunk=cfg.k_chunk), 2, 1)
    lm["attn_fwd_bwd_ms"] = cuda_ms(lambda: TF.flash_attn(
        q, k, v, k_chunk=cfg.k_chunk).sum().backward(), 2, 1)
    log(f"[time] {LM_TRAIN_ARCH} autograd attention, one layer: forward "
        f"{lm['attn_fwd_ms']!r} ms, forward + backward "
        f"{lm['attn_fwd_bwd_ms']!r} ms (a step runs the forward twice and "
        f"the backward once a layer, x {cfg.n_layers})")
    out["lm"] = lm
    del tokens, q, k, v
    torch.cuda.empty_cache()

    # -- checkpoint round trip and restart (gin-tu smoke) --------------------
    ac = get_config("gin-tu")
    cfg = ac.smoke
    batch = _smoke_batch(ac, cfg)
    step = make_step(ac, SpecBundle("train", cfg, {}, {}), rules, fast)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    state = adamw.init_state(init_params(ac, cfg, 0, device="cuda"))
    for _ in range(2):
        state, m = step(state, batch)
    snap = [(k, v.detach().clone()) for k, v in CK._flatten(state)]
    writer = CK.save(os.path.join(TRAIN_DIR, "rt"), 2, state, async_=True)
    state, m = step(state, batch)       # in place, while the writer runs
    writer.join()
    fresh = adamw.init_state(init_params(ac, cfg, 1, device="cuda"))
    back = dict(CK._flatten(CK.restore(os.path.join(TRAIN_DIR, "rt"), 2,
                                       fresh)))
    same = all(torch.equal(back[k], v) for k, v in snap)
    moved = not all(torch.equal(a, b) for (_, a), (_, b) in zip(
        snap, CK._flatten(state)))
    log(f"[check] train checkpoint: async save of step 2 while step 3 ran, "
        f"restored into a fresh state: bit-equal {same} over {len(snap)} "
        f"leaves (the live state moved on: {moved})")
    if not (same and moved):
        fail("checkpoint round trip is not bit-equal to the saved state")

    def ft_run(fails, tag):
        pending = set(fails)

        def inject(s):
            if s in pending:
                pending.discard(s)
                raise SimulatedFailure(f"injected at step {s}")
        st = adamw.init_state(init_params(ac, cfg, 0, device="cuda"))
        mgr = CK.CheckpointManager(os.path.join(TRAIN_DIR, tag),
                                   every=FT_EVERY, keep=3)
        losses = {}                   # by step; a replayed step overwrites
        st, rep = run_training(
            step, st, itertools.repeat(batch), mgr, FT_STEPS,
            FTConfig(ckpt_every=FT_EVERY), fail_injector=inject,
            on_metrics=lambda i, m: losses.__setitem__(i, float(m["loss"])))
        return st, rep, [losses[i] for i in sorted(losses)]
    st_a, rep_a, loss_a = ft_run((), "plain")
    st_b, rep_b, loss_b = ft_run(FT_FAILS, "failing")
    diff = max(float((a - b).detach().abs().max()) for a, b in zip(
        adamw.named_params(st_a.params).values(),
        adamw.named_params(st_b.params).values()))
    lrel = max(abs(a - b) / max(abs(a), 1e-12)
               for a, b in zip(loss_a, loss_b))
    log(f"[check] train restart: uninterrupted {int(st_a.step)} steps "
        f"({rep_a}); with failures at {FT_FAILS}: {int(st_b.step)} steps, "
        f"{rep_b['restarts']} restarts, {rep_b['steps_run']} steps run; "
        f"losses step for step {len(loss_a)} / {len(loss_b)}, max rel "
        f"{lrel!r} (limit {TRAIN_LOSS_RTOL}); parameters max |a - b| "
        f"{diff!r} (limit {TRAIN_PARAM_TOL})")
    if not (int(st_a.step) == int(st_b.step) == FT_STEPS
            and rep_b["restarts"] == len(FT_FAILS)
            and rep_b["steps_run"] > rep_a["steps_run"]
            and len(loss_a) == len(loss_b) == FT_STEPS):
        fail("run_training did not resume to the same step count")
    if lrel > TRAIN_LOSS_RTOL or diff > TRAIN_PARAM_TOL:
        fail(f"run_training after restarts differs from the uninterrupted "
             f"run: losses {loss_a} / {loss_b}, parameters {diff}")
    out["ckpt"] = dict(bit_equal=same, restarts=rep_b["restarts"],
                       steps_run=rep_b["steps_run"], param_diff=diff,
                       loss_rel=lrel)

    # -- the train CLI ---------------------------------------------------------
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gin-tu",
         "--smoke", "--steps", "3", "--log-every", "1", "--ckpt-dir",
         os.path.join(TRAIN_DIR, "cli")], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300)
    cli_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    log(f"[train] cli exit {proc.returncode} in {cli_s!r} s: "
        f"{lines[-1] if lines else proc.stderr[-2000:]}")
    if proc.returncode != 0 or not lines or \
            not lines[-1].startswith("done: 3 steps"):
        fail(f"the train CLI failed: {proc.stdout[-2000:]}"
             f"{proc.stderr[-2000:]}")
    out["cli_s"] = cli_s
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    out["b4_launches"] = b4_main
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[train] phase wall {out['phase_s']!r} s; B4 launches on the "
        f"training path {b4_main}")
    return out


# -- the mesh-training phase -------------------------------------------------

MESH_RANKS = 4                     # ranks sharing the card (gloo)
# gin-tu's cut graph: 65,536 is the smallest power of two at which the
# config's own dgas_threshold (4,000,000 elements) sends both the d 100
# input table (6.55 M) and the d 64 hidden table (4.19 M) through DGAS;
# degree 25 is ogb_products' average
MESH_NODES, MESH_DEGREE, MESH_STEPS = 65536, 25, 2
MESH_DIR = os.path.join(ROOT, "build", "mesh")
MESH_LOSS_RTOL = 1e-5              # meshed vs the local step's loss
MESH_GRAD_TOL = 1e-4               # of the largest gradient
MESH_PARAM_TOL = 1e-4              # phase 8's rule (TRAIN_PARAM_TOL)
MESH_FM_TOL = 1e-5                 # fm: scores, loss, w0's gradient, rows
FM_TRAIN_BATCH, FM_SERVE_BATCH = 65536, 262144   # train_batch, serve_bulk
# compression: bf16 within the reference's own tolerance of the f32 sum;
# int8 within the reference's own tolerance, and held to the bits of the
# reference's arithmetic (each rank's quantization, summed in int32, times
# the largest scale) and to that arithmetic's error bound
BF16_RTOL, BF16_ATOL = 1e-2, 1e-3
INT8_RTOL, INT8_ATOL = 0.05, 1e-3
MESH_BUDGET_S = 120.0


def _grad_param_check(g_got, g_want, p_got, p_want, lr) -> dict:
    """Phase 8's rule for two steps from the same state: gradients within
    MESH_GRAD_TOL of the largest; parameters within MESH_PARAM_TOL where
    both gradients pass MESH_GRAD_TOL of the largest or both are 0 (at
    least half the weights), within 2 lr + MESH_PARAM_TOL elsewhere."""
    import torch
    scale = max(float(v.abs().max()) for v in g_want.values())
    gerr = max(float((g_got[k] - g_want[k]).abs().max())
               for k in g_want) / scale
    perr = prest = 0.0
    n_dec = n_all = 0
    for k, want in p_want.items():
        diff = (p_got[k] - want).abs()
        t = MESH_GRAD_TOL * scale
        a, b = g_want[k], g_got[k]
        dec = ((a.abs() > t) & (b.abs() > t)) | ((a == 0) & (b == 0))
        n_dec += int(dec.sum())
        n_all += dec.numel()
        perr = max(perr, float(torch.where(dec, diff, 0).max()))
        prest = max(prest, float(torch.where(dec, 0, diff).max()))
    share = n_dec / max(n_all, 1)
    ok = (gerr <= MESH_GRAD_TOL and perr <= MESH_PARAM_TOL and share >= 0.5
          and prest <= 2 * lr + MESH_PARAM_TOL)
    return dict(grad_err=gerr, param_err=perr, param_share=share,
                param_err_rest=prest, ok=ok)


def _mesh_gin(spec, rules=None):
    """gin-tu at its published widths on the cut graph: (ArchConfig,
    model config, the global batch as CPU tensors, or over a mesh
    (``rules``) this rank's block of it on its card, read from the saved
    arrays at its rows alone: ``gnn.local_batch``)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import gnn as G
    ac = get_config("gin-tu")
    cfg = dataclasses.replace(ac.model, d_feat=spec["d_feat"],
                              n_classes=spec["classes"])
    path = lambda k: os.path.join(spec["dir"], f"gin_{k}.npy")
    keys = ("x", "src", "dst", "labels")
    if rules is None or rules.mesh is None:
        return ac, cfg, {k: torch.from_numpy(np.load(path(k)))
                         for k in keys}
    block = G.local_batch(cfg, {k: np.load(path(k), mmap_mode="r")
                                for k in keys}, rules)
    return ac, cfg, block._replace(arrays={
        k: v.to(rules.mesh.device) for k, v in block.arrays.items()})


def _mesh_fm(spec, make: bool = False):
    """fm at its published widths with ``fm_dgas``: (ArchConfig, model
    config, train batch, serve_bulk ids), batches as CPU tensors, drawn
    and saved once (``make``), then loaded."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.common import VARIANTS
    from repro_torch.data import synthetic
    ac = get_config("fm")
    cfg = VARIANTS["fm_dgas"](ac.model)
    path = lambda k: os.path.join(spec["dir"], f"fm_{k}.npy")
    if make:
        tb = next(synthetic.recsys_batches(FM_TRAIN_BATCH, cfg.n_fields,
                                           cfg.rows_per_field, seed=0))
        sb = next(synthetic.recsys_batches(FM_SERVE_BATCH, cfg.n_fields,
                                           cfg.rows_per_field, seed=1))
        for k, v in (("ids", tb["ids"]), ("labels", tb["labels"]),
                     ("serve_ids", sb["ids"])):
            np.save(path(k), v)
    load = lambda k: torch.from_numpy(np.load(path(k)))
    return (ac, cfg, {"ids": load("ids"), "labels": load("labels")},
            load("serve_ids"))


def mesh_rank(mesh, spec):
    """One rank of the mesh-training phase on a (MESH_RANKS, 1) ('data',
    'model') grid: gin-tu's meshed steps under run_training (a sharded
    checkpoint every step, a failure injected on every rank at step 2;
    each step measured: the wall, collectives per kind, dropped requests,
    B4 launches and device time, peak memory) held step for step to the
    uninterrupted local steps the parent saved, compression of step 1's
    gradients, the elastic resume on a (2, 1) mesh of ranks 0 and 1, and
    fm's meshed serve_bulk scoring and train step held to the local ones.
    Returns this rank's numbers and checks."""
    import itertools
    from unittest import mock
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import common
    from repro_torch.configs.common import (SpecBundle, init_params,
                                            make_step, param_logical_axes,
                                            param_shardings, state_shardings)
    from repro_torch.distributed import fault_tolerance as FT
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import segment_sum as SS
    from repro_torch.launch import mesh as M
    from repro_torch.models import recsys as RS
    from repro_torch.optim import adamw, compression

    t_mark = time.perf_counter()
    dev = mesh.device
    rules = make_rules(mesh)
    world = mesh.over(rules.flat)
    S = world.size
    checks = []
    out = {"rank": mesh.rank, "device": str(dev), "backend": mesh.backend,
           "steps": [], "times": {}}

    def mark(part):
        nonlocal t_mark
        now = time.perf_counter()
        out["times"][part] = now - t_mark
        t_mark = now

    def check(name, ok, detail=""):
        checks.append((name, bool(ok), detail))

    events, b4_held = [], []
    b4_call = ops.segment_sum_csr

    def timed_b4(table, offsets, rows=None, **kw):
        """B4 as the meshed step calls it (an owner's sum of the routed
        rows, -1 slots included), its device time recorded, then held to
        its plain version on the same inputs at SEG_TOL, as phase 8's
        ``checked`` holds the local path's.  The check's host seconds are
        kept apart from the step's wall, its float64 sum runs in blocks
        small beside the step's peak, and any launch it made is taken
        back out of the count."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = b4_call(table, offsets, rows, **kw)
        end.record()
        events.append((start, end))
        kept = SS.LAUNCHES["segment_sum"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # float64 sums over blocks of 16,384 entries: the check's card
        # memory (about 30 MB at d 100) stays small beside the step's peak,
        # which the step's record keeps for phase 11
        want = ref.segment_sum_csr_ref(table, offsets, rows, block=1 << 14)
        err = float((res - want).abs().max()) if res.numel() else 0.0
        ok = bool(torch.allclose(res, want, rtol=SEG_TOL, atol=SEG_TOL))
        del want
        torch.cuda.synchronize()
        b4_held.append((err, ok, time.perf_counter() - t0))
        SS.LAUNCHES["segment_sum"] = kept
        return res

    def measured(fn, args=None):
        """fn() between a barrier plus synchronize and a synchronize: its
        result and its record, with ``args`` (fn's arguments) its own peak
        as :func:`step_peak` counts it."""
        from repro_torch.launch.dryrun import storage_bytes
        mesh.barrier()
        torch.cuda.synchronize()
        mesh.reset_counts()
        SS.reset_launches()
        events.clear()
        b4_held.clear()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with mock.patch.object(ops, "segment_sum_csr", timed_b4):
            res = fn()
        torch.cuda.synchronize()
        held_s = sum(h[2] for h in b4_held)
        wall = time.perf_counter() - t0 - held_s
        mesh.settle()
        c = mesh.counts()
        rec = dict(wall_s=wall, calls=c["calls"], bytes=c["bytes"],
                   seconds=c["seconds"], card_seconds=c["card_seconds"],
                   dropped=mesh.dropped(), b4=SS.LAUNCHES["segment_sum"],
                   b4_ms=sum(s.elapsed_time(e) for s, e in events),
                   b4_held=len(b4_held),
                   b4_err=max((h[0] for h in b4_held), default=0.0),
                   b4_ok=all(h[1] for h in b4_held), b4_check_s=held_s,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        if args is not None:
            peak = torch.cuda.max_memory_allocated()
            arg_bytes = storage_bytes(args)
            rec["step_peak"] = dict(peak=peak, held=held, args=arg_bytes,
                                    step_peak=peak - held + arg_bytes)
        return res, rec

    # -- gin-tu: run_training over MESH_STEPS meshed steps, a checkpoint a
    # step and a failure injected on every rank at step 2; each step held
    # to the local (uninterrupted) step ----------------------------------------
    ac, cfg, batch = _mesh_gin(spec, rules)
    out["batch_bytes"] = {k: v.numel() * v.element_size()
                          for k, v in batch.arrays.items()}
    opt = adamw.AdamWConfig(**SMOKE_OPT)
    step = make_step(ac, SpecBundle("train", cfg, {}, {}), rules, opt)
    params = init_params(ac, cfg, 0, device=dev)
    st_shard = state_shardings(param_shardings(
        rules, params, param_logical_axes(ac, cfg, params)))
    local = torch.load(os.path.join(spec["dir"], "local_gin.pt"))
    grads = {}
    reduce = common.reduce_grads

    def keep_grads(named, sh, m):
        if not grads:
            grads["local"] = {k: p.grad.detach().clone()
                              for k, p in named.items()}
        reduce(named, sh, m)
        if "sum" not in grads:
            grads["sum"] = {k: p.grad.detach().clone()
                            for k, p in named.items()}

    def measured_step(state, b):
        with mock.patch.object(common, "reduce_grads", keep_grads):
            (state, m), rec = measured(lambda: step(state, b), (state, b))
        rec["loss"] = float(m["loss"])
        i = len(out["steps"]) + 1
        out["steps"].append(rec)
        if i == 1:
            named = adamw.named_params(state.params)
            res = _grad_param_check(
                {k: v.cpu() for k, v in grads["sum"].items()},
                local["grads1"],
                {k: p.detach().cpu() for k, p in named.items()},
                local["params1"], opt.lr)
            out["step1"] = res
            check("gin-tu step 1 gradients and parameters vs the local "
                  "step", res["ok"], f"{res}")
        return state, m

    fired = []

    def inject(s):
        if s == 1 and not fired:
            fired.append(s)
            raise FT.SimulatedFailure("injected at step 2 on every rank")
    mark("gin setup")
    t0 = time.perf_counter()
    state, rep = FT.run_training(
        measured_step, adamw.init_state(params), itertools.repeat(batch),
        ckpt.CheckpointManager(os.path.join(spec["dir"], "gin_ckpt"),
                               every=1, keep=MESH_STEPS + 1), MESH_STEPS,
        FT.FTConfig(ckpt_every=1), fail_injector=inject, shardings=st_shard)
    out["run"] = dict(restarts=rep["restarts"], steps_run=rep["steps_run"],
                      wall_s=time.perf_counter() - t0)
    losses = [r["loss"] for r in out["steps"]]
    out["losses"] = losses
    check("run_training restarted every rank from the step-1 checkpoint",
          rep["restarts"] == 1 and int(state.step) == MESH_STEPS and
          len(losses) == MESH_STEPS, f"{out['run']}")
    for i, rec in enumerate(out["steps"], 1):
        want = local[f"loss{i}"]
        rel = abs(rec["loss"] - want) / max(abs(want), 1e-12)
        check(f"gin-tu step {i} loss vs the uninterrupted local step",
              rel <= MESH_LOSS_RTOL,
              f"{rec['loss']!r} vs {want!r} (rel {rel!r})")
        check(f"gin-tu step {i} dropped requests", rec["dropped"] == 0,
              str(rec["dropped"]))
        check(f"gin-tu step {i} B4 launched", rec["b4"] > 0, str(rec["b4"]))
        check(f"gin-tu step {i} B4 on the owners' routed rows vs its plain "
              f"version (rtol / atol {SEG_TOL})",
              rec["b4_ok"] and rec["b4_held"] == rec["b4"],
              f"{rec['b4_held']} calls held of {rec['b4']} launches; largest "
              f"|kernel - plain| {rec['b4_err']!r}")

    mark("gin run_training")

    # -- compression of step 1's gradients over the ranks -------------------
    local_g, f32 = grads["local"], grads["sum"]
    n_el = sum(v.numel() for v in local_g.values())
    mesh.reset_counts()
    bf = compression.psum_bf16(local_g, world)
    b_bf16 = world.bytes["all_reduce"]
    mesh.reset_counts()
    i8, _ = compression.psum_int8_ef(local_g,
                                     compression.init_ef_state(local_g),
                                     world)
    b_int8 = world.bytes["all_gather"]
    bf_ok, i8_bits, i8_bound, ref_tol_fail = True, True, True, 0
    bf_err = i8_err = 0.0
    g_max = max(float(v.abs().max()) for v in f32.values())
    for k, x in local_g.items():
        want = f32[k]
        bf_ok &= bool(torch.allclose(bf[k], want, rtol=BF16_RTOL,
                                     atol=BF16_ATOL))
        bf_err = max(bf_err, float((bf[k] - want).abs().max()))
        q, s = compression._quant_int8(x.float())
        qs = world.all_gather(q).to(torch.int32)
        ss = world.all_gather(s.reshape(1)).reshape(-1)
        smax = ss.max()
        exact = (qs.sum(0).to(torch.float32) * smax).to(x.dtype)
        i8_bits &= bool(torch.equal(exact, i8[k]))
        # each rank's payload is off by at most its rounding (s_r / 2)
        # plus its rescale to the largest scale (|q_r| (smax - s_r))
        slack = (qs.abs().float() * (smax - ss).reshape(
            (-1,) + (1,) * q.dim())).sum(0) + ss.sum() / 2
        err = (i8[k] - want).abs()
        i8_bound &= bool((err <= slack * (1 + 1e-5) + 1e-7).all())
        i8_err = max(i8_err, float(err.max()))
        ref_tol_fail += int((err > INT8_ATOL + INT8_RTOL * want.abs()).sum())
    out["compression"] = dict(
        f32_bytes=4 * n_el, bf16_bytes=b_bf16, int8_bytes=b_int8,
        bf16_max_err=bf_err, int8_max_err=i8_err,
        int8_outside_ref_tol=ref_tol_fail, elements=n_el, grad_max=g_max)
    check("psum_bf16 vs the f32 sum", bf_ok,
          f"rtol {BF16_RTOL} atol {BF16_ATOL}; max |err| {bf_err!r}")
    check("psum_int8_ef: the bits of each rank's quantization summed in "
          "int32 times the largest scale", i8_bits)
    check("psum_int8_ef within its arithmetic's error bound", i8_bound,
          f"max |err| {i8_err!r}")
    check(f"psum_int8_ef within the reference's rtol {INT8_RTOL} / atol "
          f"{INT8_ATOL} of the f32 sum", ref_tol_fail == 0,
          f"{ref_tol_fail} of {n_el} elements outside")
    check("compression bytes halved and quartered",
          2 * b_bf16 == 4 * n_el and 4 * b_int8 == 4 * n_el,
          f"f32 {4 * n_el}, bf16 {b_bf16}, int8 {b_int8}")
    del grads, bf, i8

    del state, step, params, batch
    torch.cuda.empty_cache()
    mark("compression")

    # -- the elastic resume on a (2, 1) mesh of ranks 0 and 1 ---------------
    pair = M.make_mesh((2, 1), ("data", "model"), device="cuda",
                       ranks=[0, 1])
    if pair is not None:
        out["resume2"] = mesh_resume(pair, spec)
    mesh.barrier()
    mark("the 2-rank resume")

    # -- fm at its published widths, DGAS lookup -----------------------------
    fac, fcfg, fbatch, serve_ids = _mesh_fm(spec)
    flocal = torch.load(os.path.join(spec["dir"], "local_fm.pt"))
    whole = init_params(fac, fcfg, 0, device=dev)
    fsh = param_shardings(rules, whole,
                          param_logical_axes(fac, fcfg, whole))
    fparams = FT.reshard_state(whole, fsh)
    del whole
    torch.cuda.empty_cache()
    mark("fm setup")
    rows_pl = RS.score_rows(fcfg, rules, FM_SERVE_BATCH)
    with torch.no_grad():
        scores, srec = measured(lambda: RS.fm_scores(fcfg, fparams,
                                                     serve_ids, rules))
    want = rows_pl.block(flocal["serve_scores"])
    serr = float((scores.cpu() - want).abs().max())
    out["fm_serve"] = dict(srec, max_abs_err=serr)
    check("fm serve_bulk scores vs the local scoring",
          torch.allclose(scores.cpu(), want, rtol=MESH_FM_TOL,
                         atol=MESH_FM_TOL), f"max |err| {serr!r}")
    fstep = make_step(fac, SpecBundle("train", fcfg, {}, {}), rules, opt)
    fstate = adamw.init_state(fparams)
    (fstate, fm_m), frec = measured(lambda: fstep(fstate, fbatch))
    frec["loss"] = float(fm_m["loss"])
    out["fm_step"] = frec
    lrel = abs(frec["loss"] - flocal["loss"]) / abs(flocal["loss"])
    check("fm train_batch loss vs the local step", lrel <= MESH_FM_TOL,
          f"{frec['loss']!r} vs {flocal['loss']!r} (rel {lrel!r})")
    w0g = float(fstate.params["w0"].grad)
    check("fm w0's gradient vs the local step",
          abs(w0g - flocal["w0_grad"]) <= MESH_FM_TOL * max(
              1.0, abs(flocal["w0_grad"])), f"{w0g!r} vs {flocal['w0_grad']!r}")
    # the updated rows this rank owns
    per = fcfg.n_rows_padded // S
    ids = flocal["ids"]
    mine = (ids >= world.rank * per) & (ids < (world.rank + 1) * per)
    loc = (ids[mine] - world.rank * per).to(dev)
    table = fstate.params["table"]
    g_want = flocal["grads"][mine]
    gerr = float((table.grad[loc].cpu() - g_want).abs().max()) / float(
        flocal["grads"].abs().max())
    rerr = float((table.detach()[loc].cpu() - flocal["rows"][mine]).abs()
                 .max())
    out["fm_rows"] = dict(rows=int(mine.sum()), grad_err=gerr, row_err=rerr)
    mark("fm serve, step and checks")
    check("fm updated table rows and their gradients vs the local step",
          gerr <= MESH_FM_TOL and rerr <= MESH_FM_TOL, f"{out['fm_rows']}")
    out["checks"] = checks
    out["step_peak"] = out["steps"][-1]["step_peak"]
    return out


def mesh_resume(mesh, spec) -> dict:
    """The elastic resume on ``mesh``: gin-tu's step-1 checkpoint, written
    by MESH_RANKS ranks, restored onto its placements, then step 2."""
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.common import (SpecBundle, init_params,
                                            make_step, param_logical_axes,
                                            param_shardings, state_shardings)
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.optim import adamw
    rules = make_rules(mesh)
    ac, cfg, batch = _mesh_gin(spec, rules)
    params = init_params(ac, cfg, 1, device=mesh.device)
    sh = state_shardings(param_shardings(
        rules, params, param_logical_axes(ac, cfg, params)))
    state = ckpt.restore(os.path.join(spec["dir"], "gin_ckpt"), 1,
                         adamw.init_state(params), shardings=sh)
    step = make_step(ac, SpecBundle("train", cfg, {}, {}), rules,
                     adamw.AdamWConfig(**SMOKE_OPT))
    mesh.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    return dict(loss=float(m["loss"]), step=int(state.step),
                wall_s=time.perf_counter() - t0)


def mesh_phase(smi: str) -> dict:
    """Training over a process mesh: MESH_RANKS ranks sharing the card over
    gloo (CUDA tensors; every exchange is staged through host memory)
    train gin-tu at its published widths on a graph cut to MESH_NODES
    nodes, with the config's own DGAS threshold, held to the local step
    this process runs on the same graph, parameters and batch; fm's DGAS
    lookup at its published widths held to its local step; compression;
    the 4 -> 2 -> 1 rank resume and the restart after a failure.  Returns
    the phase's numbers; fails on any check."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.common import (SpecBundle, init_params,
                                            make_step)
    from repro_torch.core.graph import uniform_random_graph
    from repro_torch.data import synthetic
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch import mesh as M
    from repro_torch.models import recsys as RS
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    log(f"[mesh] card: {smi}")
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    spec = dict(dir=MESH_DIR, d_feat=100, classes=47)
    g = uniform_random_graph(MESH_NODES, MESH_DEGREE, seed=0, device="cpu")
    b = synthetic.gnn_batch("gin", g, spec["d_feat"], spec["classes"],
                            seed=0)
    for k in ("x", "src", "dst", "labels"):
        np.save(os.path.join(MESH_DIR, f"gin_{k}.npy"), b[k])
    E = b["src"].shape[0]
    # the batch's shapes and dtypes, for phase 11's dry run of the step
    gin_spec = dict(classes=spec["classes"], batch={
        k: (b[k].shape, b[k].dtype.name) for k in ("x", "src", "dst",
                                                   "labels")})
    del g, b

    # -- the local steps on this process (one rank, no mesh) ----------------
    ac, cfg, batch = _mesh_gin(spec)
    rules = make_rules(None)
    opt = adamw.AdamWConfig(**SMOKE_OPT)
    step = make_step(ac, SpecBundle("train", cfg, {}, {}), rules, opt)
    state = adamw.init_state(init_params(ac, cfg, 0, device="cuda"))
    local = {}
    walls = []
    for i in range(1, MESH_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        local[f"loss{i}"] = float(m["loss"])
        if i == 1:
            named = adamw.named_params(state.params)
            local["grads1"] = {k: p.grad.detach().cpu()
                               for k, p in named.items()}
            local["params1"] = {k: p.detach().cpu().clone()
                                for k, p in named.items()}
    torch.save(local, os.path.join(MESH_DIR, "local_gin.pt"))
    log(f"[mesh] gin-tu local steps on this process: losses "
        f"{[local['loss1'], local['loss2']]}, walls {walls} s")
    del state, step
    fac, fcfg, fbatch, serve_ids = _mesh_fm(spec, make=True)
    fparams = init_params(fac, fcfg, 0, device="cuda")
    with torch.no_grad():
        serve = RS.fm_scores(fcfg, fparams, serve_ids).cpu()
    fstep = make_step(fac, SpecBundle("train", fcfg, {}, {}), rules, opt)
    fstate, fm_m = fstep(adamw.init_state(fparams), fbatch)
    ids = torch.unique(fbatch["ids"].long())
    table = fstate.params["table"]
    torch.save(dict(serve_scores=serve, loss=float(fm_m["loss"]),
                    w0_grad=float(fstate.params["w0"].grad), ids=ids,
                    grads=table.grad[ids.cuda()].cpu(),
                    rows=table.detach()[ids.cuda()].cpu()),
               os.path.join(MESH_DIR, "local_fm.pt"))
    del fstate, fparams, fstep, table
    torch.cuda.empty_cache()
    prep_s = time.perf_counter() - t_phase
    log(f"[mesh] host graph uniform_random_graph({MESH_NODES}, "
        f"{MESH_DEGREE}, seed=0) ({E} edges), local gin-tu and fm steps: "
        f"{prep_s!r} s")

    # -- the ranks -------------------------------------------------------------
    t0 = time.perf_counter()
    ranks = M.spawn(mesh_rank, MESH_RANKS, device="cuda",
                    init_file=os.path.join(MESH_DIR, "init4"),
                    grid=((MESH_RANKS, 1), ("data", "model")), args=(spec,),
                    timeout=900, coll_timeout=CHIP_COLL_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    two = ranks[0]["resume2"]
    t0 = time.perf_counter()
    # one rank: the same checkpoint restored with no mesh, then step 2
    state = ckpt.restore(os.path.join(MESH_DIR, "gin_ckpt"), 1,
                         adamw.init_state(init_params(ac, cfg, 1,
                                                      device="cuda")))
    state, m = make_step(ac, SpecBundle("train", cfg, {}, {}), rules,
                         opt)(state, batch)
    one = float(m["loss"])
    one_s = time.perf_counter() - t0
    del state
    rep = ranks[0]
    log(f"[mesh] {MESH_RANKS} ranks on {[r['device'] for r in ranks]}, "
        f"backend {rep['backend']} (gloo over CUDA tensors: the ranks share "
        f"one card, every exchange staged through host memory), spawn to "
        f"exit {ranks_s!r} s; rank 0's parts {rep['times']}; the 2-rank "
        f"resume's step {two['wall_s']!r} s; the 1-rank resume {one_s!r} s")
    b4_launches = 0
    for r in ranks:
        for i, s in enumerate(r["steps"], 1):
            b4_launches += s["b4"]
            log(f"[mesh] rank {r['rank']} gin-tu step {i}: wall "
                f"{s['wall_s']!r} s, loss {s['loss']!r}; calls {s['calls']}"
                f", bytes {s['bytes']}, host s {s['seconds']}, card s "
                f"{s['card_seconds']}; dropped {s['dropped']}; B4 {s['b4']} "
                f"launches, {s['b4_ms']!r} ms, held to its plain version "
                f"(largest |err| {s['b4_err']!r}, {s['b4_check_s']!r} s of "
                f"checks kept out of the wall); peak {s['peak_gib']:.3f} GiB")
    for r in ranks:
        log(f"[mesh] rank {r['rank']} gin-tu batch: its block built from the "
            f"saved arrays at its rows alone (gnn.local_batch), bytes by key "
            f"{r['batch_bytes']}; its last step's own peak "
            f"{r['step_peak']['step_peak']} B (the B4 checks' float64 "
            f"blocks, about 30 MB, included)")
    for r in ranks:
        for tag in ("fm_serve", "fm_step"):
            s = r[tag]
            b4_launches += s["b4"]
            log(f"[mesh] rank {r['rank']} fm {tag}: wall {s['wall_s']!r} s;"
                f" calls {s['calls']}, bytes {s['bytes']}, host s "
                f"{s['seconds']}, card s {s['card_seconds']}; dropped "
                f"{s['dropped']}; B4 {s['b4']}; peak {s['peak_gib']:.3f} GiB")
    c = rep["compression"]
    log(f"[mesh] compression of step 1's gradients ({c['elements']} "
        f"elements a rank): all-reduce bytes f32 {c['f32_bytes']}, bf16 "
        f"{c['bf16_bytes']}, int8 {c['int8_bytes']}; max |err| bf16 "
        f"{c['bf16_max_err']!r}, int8 {c['int8_max_err']!r}; int8 elements "
        f"outside the reference's rtol {INT8_RTOL} / atol {INT8_ATOL}: "
        f"{c['int8_outside_ref_tol']} (its test feeds 0.01-scale gradients; "
        f"here the summed gradient reaches {c['grad_max']!r})")
    log(f"[mesh] run_training with a failure on every rank at step 2: "
        f"{rep['run']}; losses {rep['losses']} (local, uninterrupted: "
        f"{[local['loss1'], local['loss2']]})")
    checks = [(f"rank {r['rank']} {name}", ok, detail)
              for r in ranks for name, ok, detail in r["checks"]]
    want = rep["losses"][1]
    for label, got in (("2 ranks", two["loss"]), ("1 rank", one)):
        rel = abs(got - want) / max(abs(want), 1e-12)
        checks.append((f"resume on {label}: step 2's loss vs the "
                       f"{MESH_RANKS}-rank step 2", rel <= MESH_LOSS_RTOL,
                       f"{got!r} vs {want!r} (rel {rel!r})"))
    b4_ranks = [sum(s["b4"] for s in r["steps"]) for r in ranks]
    checks.append(("B4 launched on every rank in the gin-tu steps",
                   all(b > 0 for b in b4_ranks), f"{b4_ranks}"))
    phase_s = time.perf_counter() - t_phase
    checks.append((f"the phase within its {MESH_BUDGET_S} s budget",
                   phase_s <= MESH_BUDGET_S, f"{phase_s!r} s"))
    for name, ok, detail in checks:
        log(f"[check] mesh {name}: {'ok' if ok else 'FAILED'}; {detail}")
    log(f"[mesh] phase wall {phase_s!r} s ("
        f"{'within' if phase_s <= MESH_BUDGET_S else 'OVER'} the "
        f"{MESH_BUDGET_S} s budget); cuts: the graph ({MESH_NODES} nodes of "
        f"ogb_products' 2,449,029), {MESH_STEPS} steps")
    failed = [c[0] for c in checks if not c[1]]
    if failed:
        fail(f"the mesh-training phase failed: {failed}")
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    return {"phase_s": phase_s, "prep_s": prep_s, "ranks_s": ranks_s,
            "resume1_s": one_s,
            "b4_launches": b4_launches, "ranks": ranks, "resume2": two,
            "resume1_loss": one, "gin_spec": gin_spec}


# -- the LM-over-a-mesh phase ------------------------------------------------

LMMESH_RANKS = 4                   # ranks sharing the card (gloo)
LMMESH_GRID = (2, 2)               # training: FSDP over data, TP over model
# serving: TP over model alone (FSDP would all-gather every weight on
# every decode step, staged through host memory by gloo)
LMMESH_SERVE_GRID = (1, 4)
LMMESH_SMOKE = ("qwen3-14b", "minicpm3-4b", "mixtral-8x7b",
                "llama4-maverick-400b-a17b")
LMMESH_SP = "qwen3-14b"            # the dense config also run seq-parallel
LMMESH_SMOKE_BATCH = (4, 16)       # data and model both divide it
LMMESH_STEPS = 2
LMMESH_DIR = os.path.join(ROOT, "build", "lmmesh")
LMMESH_SERVE_REF = os.path.join(LMMESH_DIR, "serve_ref.pt")
LMMESH_BUDGET_S = 240.0


def _row_err(got, want) -> float:
    """Largest per-row ||got - want|| / ||want|| over the last dim."""
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1)
                  / want.norm(dim=-1).clamp_min(1e-30)).max())


def lmmesh_rank(mesh, spec):
    """One rank of the LM-over-a-mesh phase on a LMMESH_GRID ('data',
    'model') grid: the smoke LMs' meshed train steps held to the CPU's;
    minicpm3-4b at its published widths for LMMESH_STEPS steps from its
    blocks of the one-card draw (each step measured: the wall, collectives
    per kind, peak memory); then, on a LMMESH_SERVE_GRID mesh of the same
    ranks, qwen3-14b served through ``serve_lm`` with B6 on this rank's
    heads, each B6 call of prefill and MODEL_PLAIN_STEPS decode steps held
    to its plain version, the logits to phase 7's one-card logits where
    they read phase 7's ids.  Returns this rank's numbers and checks."""
    import dataclasses
    from unittest import mock
    import numpy as np
    import torch
    from repro_torch.configs import get_config, input_specs
    from repro_torch.configs.common import (SpecBundle, init_params,
                                            make_step, param_logical_axes,
                                            param_shardings)
    from repro_torch.data import synthetic
    from repro_torch.distributed import fault_tolerance as FT
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import mesh as M
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adamw

    dev = mesh.device
    rules = make_rules(mesh)
    checks, out = [], {"rank": mesh.rank, "device": str(dev),
                       "backend": mesh.backend, "smoke": {}, "steps": []}

    def check(name, ok, detail=""):
        checks.append((name, bool(ok), detail))

    def blocks(ac, cfg, r):
        shapes = init_params(ac, cfg, 0, device="meta")
        return param_shardings(r, shapes, param_logical_axes(ac, cfg,
                                                             shapes))

    def measured(m, fn):
        """fn() between a barrier plus synchronize and a synchronize: its
        result and record (wall, collectives per kind, peak memory)."""
        m.barrier()
        torch.cuda.synchronize()
        m.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m.settle()
        c = m.counts()
        return res, dict(wall_s=wall, calls=c["calls"], bytes=c["bytes"],
                         seconds=c["seconds"],
                         card_seconds=c["card_seconds"],
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30)

    # -- the smoke LMs, card over the grid vs the CPU step --------------------
    t0 = time.perf_counter()
    runs = [(a, False) for a in LMMESH_SMOKE] + [(LMMESH_SP, True)]
    for arch, sp in runs:
        ac = get_config(arch)
        cfg = ac.smoke
        want = torch.load(os.path.join(spec["dir"], f"smoke_{arch}.pt"))
        r = make_rules(mesh, seq_parallel=sp)
        model = TF.Transformer(cfg, device=dev)
        model.load_state_dict(want["state"])
        FT.reshard_state(model, blocks(ac, cfg, r))
        step = make_step(ac, SpecBundle("train", cfg, {}, {}), r,
                         adamw.AdamWConfig(**SMOKE_OPT))
        mesh.reset_counts()
        st, m = step(adamw.init_state_with_dtype(model, ac.moment_dtype),
                     {"tokens": want["tokens"]})
        calls = dict(mesh.calls)
        pl = model.placements
        got_g = {k: pl[k].whole(p.grad).float().cpu()
                 for k, p in model.named_parameters()}
        got_p = {k: pl[k].whole(p.detach()).float().cpu()
                 for k, p in model.named_parameters()}
        rel = abs(float(m["loss"]) - want["loss"]) / max(abs(want["loss"]),
                                                         1e-12)
        res = _grad_param_check(got_g, want["grads"], got_p, want["params"],
                                SMOKE_OPT["lr"])
        tag = f"{arch}{' seq-parallel' if sp else ''}"
        out["smoke"][tag] = dict(loss=float(m["loss"]), cpu=want["loss"],
                                 rel=rel, calls=calls, **res)
        check(f"smoke {tag} over {LMMESH_GRID}: loss vs the CPU step, rel "
              f"<= {TRAIN_LOSS_RTOL}", rel <= TRAIN_LOSS_RTOL,
              f"{float(m['loss'])!r} vs {want['loss']!r} (rel {rel!r})")
        check(f"smoke {tag}: gradients and parameters by phase 8's rule",
              res["ok"], f"{res}")
        del model, st, step
    out["smoke_s"] = time.perf_counter() - t0

    # -- minicpm3-4b at its published widths over the grid ------------------
    ac = get_config(LM_TRAIN_ARCH)
    bundle = input_specs(ac, "train_4k")
    cfg = bundle.model
    seq = spec["seq"]
    tokens = torch.from_numpy(next(synthetic.lm_batches(
        LM_TRAIN_BATCH, seq, cfg.vocab, seed=0))["tokens"]).to(dev)
    t0 = time.perf_counter()
    sh = blocks(ac, cfg, rules)
    model = init_params(ac, cfg, 0, device=dev, shardings=sh)
    state = adamw.init_state_with_dtype(model, ac.moment_dtype)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    named = dict(model.named_parameters())
    out["block_params"] = sum(p.numel() for p in named.values())
    out["state_gb"] = sum(t.numel() * t.element_size() for t in
                          list(named.values()) + list(state.m.values())
                          + list(state.v.values())) / 1e9
    step = make_step(ac, dataclasses.replace(bundle, model=cfg), rules,
                     adamw.AdamWConfig(lr=LM_TRAIN_LR, warmup_steps=0,
                                       total_steps=30, weight_decay=0.0))
    before = {k: p.detach().to("cpu", copy=True) for k, p in named.items()}
    for i in range(1, LMMESH_STEPS + 1):
        FA.reset_launches()
        (state, m), rec = measured(mesh, lambda: step(state,
                                                      {"tokens": tokens}))
        rec.update(loss=float(m["loss"]), b6=FA.LAUNCHES["flash_attention"])
        out["steps"].append(rec)
        if i > 1:
            continue
        bad = [k for k, p in named.items() if p.grad is None
               or not bool(torch.isfinite(p.grad).all())
               or not bool((p.grad != 0).any())]
        check(f"{LM_TRAIN_ARCH} step 1: every block of this rank has a "
              f"finite nonzero gradient", not bad,
              f"{len(named) - len(bad)} of {len(named)}; {bad[:4]}")
        moved = sum(int((named[k].detach() != w.to(dev)).sum())
                    for k, w in before.items())
        out["moved"] = moved
        del before
    losses = [s["loss"] for s in out["steps"]]
    check(f"{LM_TRAIN_ARCH} losses finite", all(np.isfinite(losses)),
          f"{losses}")
    check(f"{LM_TRAIN_ARCH} steps launched no B6",
          not any(s["b6"] for s in out["steps"]),
          f"{[s['b6'] for s in out['steps']]}")
    del state, model, named, step, tokens
    torch.cuda.empty_cache()

    # -- qwen3-14b served over the serving grid, B6 on each rank's heads ----
    smesh = M.make_mesh(LMMESH_SERVE_GRID, ("data", "model"), device=dev)
    srules = make_rules(smesh)
    ac = get_config(MODEL_ARCH)
    cfg = ac.model
    L, G, P, Bm = cfg.n_layers, MODEL_GEN, MODEL_PROMPT, MODEL_BATCH
    want = torch.load(LMMESH_SERVE_REF)
    t0 = time.perf_counter()
    model = init_params(ac, cfg, 0, device=dev,
                        shardings=blocks(ac, cfg, srules)
                        ).requires_grad_(False)
    torch.cuda.synchronize()
    out["serve_init_s"] = time.perf_counter() - t0
    wq = model.layers[0].attn["wq"]
    wk = model.layers[0].attn["wk"]
    out["heads"] = (wq.shape[1] // cfg.head_dim, wk.shape[1] // cfg.head_dim)
    prompts = want["prompts"]
    FA.reset_launches()
    run, rec = measured(smesh, lambda: serve_lm(cfg, model, prompts, G,
                                                rules=srules,
                                                keep_logits=True))
    out["serve"] = dict(rec, b6=dict(FA.LAUNCHES),
                        prefill_s=run["prefill_s"], decode_s=run["decode_s"],
                        decode_ms_per_step=1e3 * run["decode_s"] / G,
                        tokens_per_s=run["tok_per_s"],
                        ids=run["tokens"].tolist(),
                        same_ids=bool(np.array_equal(
                            run["tokens"], want["tokens"].numpy())))
    b6 = out["serve"]["b6"]
    expect = {"flash_attention": L * (1 + G), "flash_attention_wgmma": L,
              "flash_attention_split": L * G}
    check(f"serve: B6 launches on this rank's heads {out['heads']}",
          all(b6[k] == v for k, v in expect.items()),
          f"{b6} (want {expect}: {L} wgmma on prefill, {L} split a decode "
          f"step)")

    # the logits against phase 7's one-card logits: the greedy run's,
    # prefill and every (row, step) whose ids so far are phase 7's (a
    # step's logits read them all), then those of phase 7's ids fed again
    # through prefill and MODEL_PLAIN_STEPS decode steps, each B6 call of
    # which is held to its plain version; the collectives of prefill and
    # of a decode step counted
    same = np.cumprod(run["tokens"] == want["tokens"].numpy(), axis=1)
    steps = run["step_logits"].cpu()
    errs = [_row_err(run["prefill_logits"].cpu(), want["prefill_logits"])]
    errs += [_row_err(steps[t, b], want["step_logits"][t, b])
             for b, t in zip(*np.nonzero(same))]
    out["greedy_rows_compared"] = int(same.sum())
    del run, steps
    real, readings = ops.flash_attention, []

    def checked(q, k, v, *, causal=True, window=None):
        got = real(q, k, v, causal=causal, window=window)
        w = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        reading = attention_reading(got, w)
        if not readings or q.shape[2] != readings[-1][0]:
            faulty = masked_attention(q, k, v, own_block_left_out(
                q.shape[2], k.shape[2], causal, window, q.device))
            reading += attention_reading(faulty, w)
        readings.append((q.shape[2],) + reading)
        return got

    toks = want["tokens"].to(dev)
    logits = []
    with torch.inference_mode():
        smesh.reset_counts()
        with mock.patch.object(ops, "flash_attention", checked):
            lg, cache = TF.prefill(cfg, model, prompts, srules)
        out["prefill_calls"] = dict(smesh.calls)
        out["prefill_bytes"] = dict(smesh.bytes)
        logits.append(lg.cpu())
        cache = TF.grow_cache(cache, P + G)
        for t in range(MODEL_PLAIN_STEPS):
            smesh.reset_counts()
            with mock.patch.object(ops, "flash_attention", checked):
                lg, cache = TF.decode_step(cfg, model, cache,
                                           toks[:, t:t + 1], srules)
            logits.append(lg.cpu())
        out["step_calls"] = dict(smesh.calls)
        out["step_bytes"] = dict(smesh.bytes)
    del cache
    kernel_row = max(r[1] for r in readings)
    kernel_el = max(r[2] for r in readings)
    faults = [r[3:] for r in readings if len(r) > 3]
    out["b6_checked"] = dict(calls=len(readings), row_err=kernel_row,
                             el_err=kernel_el, faults=faults)
    check(f"serve: B6 calls of prefill and {MODEL_PLAIN_STEPS} decode steps "
          f"vs the plain version, per call",
          len(readings) == L * (1 + MODEL_PLAIN_STEPS)
          and kernel_row <= ATTN_ROW_TOL and kernel_el <= 1.0,
          f"{len(readings)} calls, per row max {kernel_row!r} (limit "
          f"{ATTN_ROW_TOL}), element max {kernel_el!r} of its limit")
    check("serve: a planted fault fails the B6 check",
          len(faults) == 2 and all(f[0] > ATTN_ROW_TOL or f[1] > 1.0
                                   for f in faults), f"{faults}")
    errs += [_row_err(logits[0], want["prefill_logits"])]
    errs += [_row_err(logits[t + 1], want["step_logits"][t])
             for t in range(MODEL_PLAIN_STEPS)]
    err = max(errs)
    out["logit_err"] = err
    check(f"serve: logits vs phase 7's one-card logits (the greedy run's "
          f"prefill and {out['greedy_rows_compared']} of its {Bm * G} "
          f"(row, step) pairs on phase 7's ids; phase 7's ids fed through "
          f"prefill and {MODEL_PLAIN_STEPS} steps)", err <= want["limit"],
          f"per row max ||a - b|| / ||b|| {err!r} (limit {want['limit']!r} "
          f"= {MODEL_FLOOR_FACTOR} x phase 7's floor {want['floor']!r})")
    out["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["checks"] = checks
    return out


def lmmesh_phase(smi: str, lm_losses: dict) -> dict:
    """The LM over a process mesh: LMMESH_RANKS ranks sharing the card over
    gloo (CUDA tensors; every exchange staged through host memory) run the
    smoke LMs' train steps over a LMMESH_GRID grid, held to the CPU's from
    the same parameters and batch; minicpm3-4b at its published widths for
    LMMESH_STEPS steps, step 1's loss held to phase 8's one-card bf16 step
    1 on the same weights and batch; qwen3-14b served over a
    LMMESH_SERVE_GRID grid, held to phase 7.  ``lm_losses``: phase 8's
    step-1 losses in bf16 and with f32 weights.  Returns the phase's
    numbers; fails on any check or past LMMESH_BUDGET_S."""
    import dataclasses
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs import get_config, input_specs
    from repro_torch.configs.common import SpecBundle, init_params, make_step
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch import mesh as M
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    log(f"[lmmesh] card: {smi}")
    for name in os.listdir(LMMESH_DIR):
        if name != os.path.basename(LMMESH_SERVE_REF):
            os.unlink(os.path.join(LMMESH_DIR, name))
    rng = np.random.default_rng(5)
    for arch in LMMESH_SMOKE:
        ac = get_config(arch)
        cfg = ac.smoke
        model = init_params(ac, cfg, 1, device="cpu")
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab, LMMESH_SMOKE_BATCH).astype(np.int32))
        step = make_step(ac, SpecBundle("train", cfg, {}, {}),
                         make_rules(None), adamw.AdamWConfig(**SMOKE_OPT))
        st, m = step(adamw.init_state_with_dtype(model, ac.moment_dtype),
                     {"tokens": tokens})
        torch.save(dict(state=state, tokens=tokens, loss=float(m["loss"]),
                        grads={k: p.grad.float() for k, p in
                               model.named_parameters()},
                        params={k: p.detach().float() for k, p in
                                model.named_parameters()}),
                   os.path.join(LMMESH_DIR, f"smoke_{arch}.pt"))
    seq = input_specs(get_config(LM_TRAIN_ARCH), "train_4k").batch[
        "tokens"].shape[1]
    spec = dict(dir=LMMESH_DIR, seq=seq)
    prep_s = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    ranks = M.spawn(lmmesh_rank, LMMESH_RANKS, device="cuda",
                    init_file=os.path.join(LMMESH_DIR, "init4"),
                    grid=(LMMESH_GRID, ("data", "model")), args=(spec,),
                    timeout=600, coll_timeout=CHIP_COLL_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    rep = ranks[0]
    log(f"[lmmesh] {LMMESH_RANKS} ranks on {[r['device'] for r in ranks]}, "
        f"backend {rep['backend']} (gloo over CUDA tensors: the ranks share "
        f"one card, every exchange staged through host memory); the CPU "
        f"steps of the smoke configs {prep_s!r} s; spawn to exit "
        f"{ranks_s!r} s")
    for tag, s in rep["smoke"].items():
        log(f"[lmmesh] smoke {tag} over {LMMESH_GRID}: loss {s['loss']!r} "
            f"(CPU {s['cpu']!r}, rel {s['rel']!r}); gradients "
            f"{s['grad_err']!r} of the largest, parameters {s['param_err']!r}"
            f" where decided ({s['param_share']!r} of them); collectives "
            f"{s['calls']}")
    params = sum(r["block_params"] for r in ranks)
    log(f"[lmmesh] {LM_TRAIN_ARCH} at its published widths over "
        f"{LMMESH_GRID}: {params} parameters in the ranks' blocks (a "
        f"block split over one axis counted on each rank that holds it), "
        f"{[round(r['state_gb'], 3) for r in ranks]} GB of state a rank "
        f"(bf16 weights, moments {get_config(LM_TRAIN_ARCH).moment_dtype}),"
        f" blocks drawn in {[round(r['init_s'], 3) for r in ranks]} s; "
        f"batch {LM_TRAIN_BATCH} x {seq}")
    for r in ranks:
        for i, s in enumerate(r["steps"], 1):
            log(f"[lmmesh] rank {r['rank']} {LM_TRAIN_ARCH} step {i}: wall "
                f"{s['wall_s']!r} s, loss {s['loss']!r}; calls {s['calls']}"
                f", bytes {s['bytes']}, host s {s['seconds']}, card s "
                f"{s['card_seconds']}; peak {s['peak_gib']:.3f} GiB ({smi})")
    moved = sum(r["moved"] for r in ranks) / params
    bf16, f32 = lm_losses["bf16"], lm_losses["f32"]
    floor = abs(bf16 - f32)
    got = rep["steps"][0]["loss"]
    limit = MODEL_FLOOR_FACTOR * floor
    checks = [(f"rank {r['rank']} {name}", ok, detail)
              for r in ranks for name, ok, detail in r["checks"]]
    checks.append((f"{LM_TRAIN_ARCH} step 1 changed at least "
                   f"{LM_MOVED_MIN} of the weights", moved >= LM_MOVED_MIN,
                   f"{moved!r}"))
    checks.append((f"{LM_TRAIN_ARCH} step 1's loss vs phase 8's one-card "
                   f"bf16 step 1 (same weights and batch)",
                   abs(got - bf16) <= limit,
                   f"{got!r} vs {bf16!r}: |diff| {abs(got - bf16)!r}, limit "
                   f"{limit!r} = {MODEL_FLOOR_FACTOR} x the rounding floor "
                   f"{floor!r} (phase 8's step 1 in bf16 vs with f32 "
                   f"weights, {f32!r})"))
    checks.append(("every rank's losses equal",
                   all(r["steps"][i]["loss"] == rep["steps"][i]["loss"]
                       for r in ranks for i in range(LMMESH_STEPS)),
                   f"{[[s['loss'] for s in r['steps']] for r in ranks]}"))
    for r in ranks:
        s = r["serve"]
        log(f"[lmmesh] rank {r['rank']} {MODEL_ARCH} served over "
            f"{LMMESH_SERVE_GRID}: {r['heads'][0]} q heads, {r['heads'][1]} "
            f"kv heads; blocks drawn in {r['serve_init_s']!r} s; prefill "
            f"{MODEL_BATCH} x {MODEL_PROMPT} {s['prefill_s']!r} s, decode "
            f"{s['decode_ms_per_step']!r} ms a step, {s['tokens_per_s']!r} "
            f"tokens/s; B6 {s['b6']}; main path calls {s['calls']}, bytes "
            f"{s['bytes']}, host s {s['seconds']}, card s "
            f"{s['card_seconds']}; prefill collectives {r['prefill_calls']}"
            f" ({r['prefill_bytes']} bytes), a decode step's "
            f"{r['step_calls']} ({r['step_bytes']} bytes); logits vs phase "
            f"7 {r['logit_err']!r}; greedy ids equal to phase 7's "
            f"{s['same_ids']} ({r['greedy_rows_compared']} of "
            f"{MODEL_BATCH * MODEL_GEN} (row, step) pairs on them); peak "
            f"{r['serve_peak_gib']:.3f} GiB ({smi})")
    checks.append(("every rank decoded the same ids",
                   all(r["serve"]["ids"] == rep["serve"]["ids"]
                       for r in ranks), f"{MODEL_BATCH} x {MODEL_GEN}"))
    phase_s = time.perf_counter() - t_phase
    checks.append((f"the phase within its {LMMESH_BUDGET_S} s budget",
                   phase_s <= LMMESH_BUDGET_S, f"{phase_s!r} s"))
    for name, ok, detail in checks:
        log(f"[check] lmmesh {name}: {'ok' if ok else 'FAILED'}; {detail}")
    log(f"[lmmesh] phase wall {phase_s!r} s ("
        f"{'within' if phase_s <= LMMESH_BUDGET_S else 'OVER'} the "
        f"{LMMESH_BUDGET_S} s budget); cuts: {LM_TRAIN_ARCH} at batch "
        f"{LM_TRAIN_BATCH} (train_4k's 256) for {LMMESH_STEPS} steps")
    failed = [c[0] for c in checks if not c[1]]
    if failed:
        fail(f"the LM-over-a-mesh phase failed: {failed}")
    shutil.rmtree(LMMESH_DIR, ignore_errors=True)
    return {"phase_s": phase_s, "prep_s": prep_s, "ranks_s": ranks_s,
            "moved": moved, "loss_floor": floor, "loss_limit": limit,
            "b6_launches": sum(r["serve"]["b6"]["flash_attention"]
                               for r in ranks),
            "ranks": [{k: v for k, v in r.items() if k != "checks"}
                      for r in ranks]}


DRY_PEAK_TOL = 0.15                # dry peak vs the card's, relative
DRY_BUDGET_S = 90.0
EXAMPLES = os.path.join(ROOT, "examples")
EXAMPLE_TRACE = os.path.join(ROOT, "build", "graph_analytics_trace.json")
EXAMPLE_CKPT = os.path.join(ROOT, "build", "train_lm_example")
QUICKSTART_PR_TOL = 1e-4


def _example(name: str):
    """examples/<name>.py as a module (its ``main(argv) -> dict``)."""
    import importlib
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    return importlib.import_module(name)


def _meta_batch(specs: dict) -> dict:
    """Meta tensors of {name: (shape, numpy dtype name)}."""
    import numpy as np
    import torch
    return {k: torch.empty(tuple(shape), device="meta", dtype=torch.from_numpy(
        np.empty(0, dtype)).dtype) for k, (shape, dtype) in specs.items()}


def dryrun_phase(smi: str, model: dict, train: dict, meshed: dict,
                 lmmesh: dict) -> dict:
    """Phase 11: the dry run (``repro_torch.launch.dryrun``) held to what
    the card measured in this run, and the four examples run on the card.
    Rank 0's collective calls and bytes per kind of qwen3-14b's prefill and
    one decode step over a dry (1, 4) mesh must equal phase 10's, and of
    gin-tu's meshed step over a dry (4, 1) mesh (rank 0's block of the
    batch, as phase 9's rank 0 took it) phase 9's; the dry peak of
    qwen3-14b's prefill and of gin-tu's ogb_products warm step on one card
    must be within DRY_PEAK_TOL of phases 7's and 8's, of that meshed step
    of phase 9's rank 0's last step, and of MLA_ARCH's 1 x MLA_PROMPT
    prefill (:func:`dry_mla_prefill`, traced here after the measured
    phases) of phase 7's; no trace may launch a kernel.  Then quickstart
    on the card against ``--device cpu``, graph_analytics with 4 ranks,
    train_lm's demo and serve_lm, each with its kernels' launches
    counted.  Fails past DRY_BUDGET_S."""
    import dataclasses
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs import get_config, input_specs
    from repro_torch.configs.common import SpecBundle
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import segment_sum as SS
    from repro_torch.kernels import spmv_dma as K
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_dry_mesh
    from repro_torch.models import transformer as TF

    t_phase = time.perf_counter()
    out, checks = {"nvidia_smi": smi}, []

    def check(name, ok, detail=""):
        checks.append((name, bool(ok), detail))
        log(f"[check] dryrun {name}: {'ok' if ok else 'FAILED'}; {detail}")

    def kernel_counts():
        return {**SS.LAUNCHES, **FA.LAUNCHES, **K.LAUNCHES}

    # -- collective bytes: rank 0 of this run's meshes, traced on meta -----
    before = kernel_counts()
    ac = get_config(MODEL_ARCH)
    cfg = ac.model
    Bm, P, G = MODEL_BATCH, MODEL_PROMPT, MODEL_GEN
    srules = make_rules(make_dry_mesh(LMMESH_SERVE_GRID, ("data", "model")))
    tokens = torch.empty((Bm, P), dtype=torch.int32, device="meta")
    pre = D.dry_step(ac, SpecBundle("prefill", cfg, {"tokens": tokens}, {}),
                     srules)
    dec = D.dry_step(ac, SpecBundle(
        "decode", cfg, {"tokens": tokens[:, :1]}, {},
        cache=TF.init_cache(cfg, Bm, P + G, device="meta")), srules,
        position=P + MODEL_PLAIN_STEPS - 1)
    rank0 = lmmesh["ranks"][0]
    for label, got, calls, nbytes in (
            ("qwen3-14b prefill", pre, rank0["prefill_calls"],
             rank0["prefill_bytes"]),
            ("qwen3-14b decode step", dec, rank0["step_calls"],
             rank0["step_bytes"])):
        dry = {k: (c["count"], c["bytes"])
               for k, c in got["collectives"].items()}
        card = {k: (calls[k], nbytes[k]) for k in calls}
        out[label] = dict(dry=dry, card=card, trace_s=got["trace_s"])
        check(f"{label} over a dry {LMMESH_SERVE_GRID} mesh: rank 0's "
              f"calls and bytes per kind vs phase 10's", dry == card,
              f"dry {dry}, card {card}")
    gac = get_config("gin-tu")
    gbatch = _meta_batch(meshed["gin_spec"]["batch"])
    gcfg = dataclasses.replace(gac.model, d_feat=gbatch["x"].shape[1],
                               n_classes=meshed["gin_spec"]["classes"])
    gmesh = make_dry_mesh((MESH_RANKS, 1), ("data", "model"))
    gin = D.dry_step(gac, SpecBundle("train", gcfg, gbatch, {}),
                     make_rules(gmesh))
    rec = meshed["ranks"][0]["steps"][-1]
    dry = {k: (c["count"], c["bytes"]) for k, c in gin["collectives"].items()}
    card = {k: (rec["calls"][k], rec["bytes"][k]) for k in rec["calls"]}
    out["gin-tu meshed step"] = dict(dry=dry, card=card,
                                     trace_s=gin["trace_s"])
    check(f"gin-tu's step over a dry ({MESH_RANKS}, 1) mesh: rank 0's calls "
          f"and bytes per kind vs phase 9's", dry == card,
          f"dry {dry}, card {card}")

    # -- peaks: one card, the same shapes as phases 7 and 8 -----------------
    one = make_rules(None)
    p_dry = D.dry_step(ac, SpecBundle("prefill", cfg, {"tokens": tokens},
                                      {}), one)
    gbundle = input_specs(gac, GIN_SHAPE)
    g_dry = D.dry_step(gac, gbundle, one)
    m_dry = dry_mla_prefill()
    t2, t3 = m_dry["temporaries"].values()
    log(f"[dryrun] {MLA_ARCH} prefill 1 x {MLA_PROMPT} traced at "
        f"{MLA_DRY_DEPTH} and {MLA_DRY_DEPTH + 1} layers in "
        f"{m_dry['trace_s']!r} s: temporaries {t2} and {t3} B, a layer's "
        f"cache {m_dry['layer_cache_bytes']} B")
    check(f"{MLA_ARCH} prefill's dry temporaries grow by one layer's cache "
          f"a layer", t3 - t2 == m_dry["layer_cache_bytes"],
          f"{t3} - {t2} = {t3 - t2} B vs {m_dry['layer_cache_bytes']} B")
    for label, got, card in (
            (f"qwen3-14b prefill {Bm} x {P}", p_dry,
             model["prefill_peak"]),
            (f"gin-tu {GIN_SHAPE} warm step", g_dry,
             train["gin"]["step_peak"]),
            (f"gin-tu meshed step, rank 0 of ({MESH_RANKS}, 1)", gin,
             meshed["ranks"][0]["step_peak"]),
            (f"{MLA_ARCH} prefill 1 x {MLA_PROMPT}", m_dry,
             model["mla"]["prefill_peak"])):
        rel = abs(got["peak_bytes"] - card["step_peak"]) / card["step_peak"]
        out[f"peak {label}"] = dict(dry=got["peak_bytes"],
                                    dry_args=got["argument_bytes"],
                                    card=card, rel=rel,
                                    trace_s=got["trace_s"])
        check(f"{label}: the dry peak vs the card's own", rel <= DRY_PEAK_TOL,
              f"dry {got['peak_bytes']} B (arguments "
              f"{got['argument_bytes']} B) vs card {card['step_peak']} B "
              f"(arguments {card['args']} B): {rel!r} (limit "
              f"{DRY_PEAK_TOL})")
    after = kernel_counts()
    check("the dry traces launched no kernel", after == before,
          f"{before} -> {after}")
    out["dry_s"] = time.perf_counter() - t_phase
    log(f"[dryrun] dry traces in {out['dry_s']!r} s")

    # -- the examples on the card -----------------------------------------
    def run(name, argv):
        for mod in (SS, FA, K):
            mod.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            res = _example(name).main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in kernel_counts().items() if v}
        log(f"[dryrun] example {name} {' '.join(argv)}: {wall!r} s; "
            f"launches {counts}")
        out[f"example {name}"] = dict(wall_s=wall, launches=counts)
        return res, counts

    qs, qc = run("quickstart_torch", [])
    qs_cpu, _ = run("quickstart_torch", ["--device", "cpu"])
    pr_diff = float(np.abs(qs["pagerank"] - qs_cpu["pagerank"]).max())
    check("quickstart: card vs --device cpu",
          np.array_equal(qs["levels"], qs_cpu["levels"])
          and pr_diff <= QUICKSTART_PR_TOL
          and qs["table1"] == qs_cpu["table1"]
          and qc.get("spmv_bbcsr", 0) > 0,
          f"BFS levels equal {np.array_equal(qs['levels'], qs_cpu['levels'])}"
          f", PageRank max |diff| {pr_diff!r} (limit {QUICKSTART_PR_TOL}), "
          f"Table I {qs['table1']} vs {qs_cpu['table1']}, B1 launches "
          f"{qc.get('spmv_bbcsr', 0)}")
    ga, gc = run("graph_analytics_torch",
                 ["--scale", "12", "--ranks", str(MESH_RANKS), "--stream",
                  "2", "--trace", EXAMPLE_TRACE])
    dist = ga.get("distributed") or {}
    check("graph_analytics: B1, B2, B3 launched; the served streams and "
          "the distributed demo answered",
          all(gc.get(k, 0) > 0 for k in ("spmv_bbcsr", "spmspv_bbcsr_add",
                                           "spmspv_bbcsr_select"))
          and abs(ga["pagerank_mass"] - 1.0) <= 1e-3
          and ga["bfs_reached"] == ga["sssp_reached"]
          and dist.get("queries") == 64 and os.path.exists(EXAMPLE_TRACE),
          f"launches {gc}, pagerank mass {ga['pagerank_mass']!r}, bfs / "
          f"sssp reached {ga['bfs_reached']} / {ga['sssp_reached']}, "
          f"distributed {dist}")
    shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)
    tl, tc = run("train_lm_torch", ["--demo", "--steps", "20", "--ckpt-dir",
                                    EXAMPLE_CKPT])
    losses = [r["loss"] for r in tl["losses"]]
    check("train_lm --demo --steps 20: the loss falls, a checkpoint at step "
          "20, no B6 in a train step",
          tl["steps_run"] == 20 and losses[-1] < losses[0]
          and tl["checkpoint_step"] == 20
          and not tc.get("flash_attention"),
          f"losses {losses}, checkpoint {tl['checkpoint_step']}, launches "
          f"{tc}")
    shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)
    sl, sc = run("serve_lm_torch", [])
    check("serve_lm: B6 launched", sc.get("flash_attention", 0) > 0
          and sl["tokens"].shape == (4, 24), f"launches {sc}")
    out["examples"] = dict(quickstart=dict(pagerank_diff=pr_diff),
                           graph_analytics={k: v for k, v in ga.items()
                                            if k != "stream"},
                           train_lm=dict(losses=losses, seconds=tl["seconds"]),
                           serve_lm={k: v for k, v in sl.items()
                                     if k != "tokens"})
    phase_s = time.perf_counter() - t_phase
    out["phase_s"] = phase_s
    check(f"the phase within its {DRY_BUDGET_S} s budget",
          phase_s <= DRY_BUDGET_S, f"{phase_s!r} s ({smi})")
    failed = [c[0] for c in checks if not c[1]]
    if failed:
        fail(f"the dry-run phase failed: {failed}")
    return out


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
    log(f"[device] total_memory "
        f"{torch.cuda.get_device_properties(0).total_memory} B")

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
    dist_ref = {"sources": sources, "msbfs": lv_b.cpu().numpy(),
                "sssp_batched": d_b[:DIST_BATCHED].cpu().numpy(),
                "delta": np.float32(delta)}
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

    pr = path("pagerank", lambda: pagerank(g, iters=PAGERANK_ITERS))
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
    sm_row, structured, lpa, kept = structured_phase(
        g, lv_p, d_p, labels, delta, counted, err, args)
    structured["phase_s"] = time.perf_counter() - t0
    log(f"[structured] phase wall {structured['phase_s']!r} s")
    log(f"[mem] structured phase peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # the distributed phase, on the same graph, held to phases 3-4's and
    # the structured phase's results
    dist_ref.update(bfs=lv_p.cpu().numpy(), sssp=d_p.cpu().numpy(),
                    cc=labels.cpu().numpy(), pagerank=pr.cpu().numpy(),
                    spmv=spmv(g, x).cpu().numpy(), lpa=lpa.cpu().numpy(),
                    pr_iters=np.int32(PAGERANK_ITERS))
    del lpa
    torch.cuda.empty_cache()
    dist = dist_phase(g, x, dist_ref, smi)
    launches["segment_or"] += dist["launches"]["segment_or"]
    sm_row["launches"] += dist["launches"]["segment_mode"]
    sm_row["entry_launches"]["segment_mode"] += \
        dist["launches"]["segment_mode"]
    # the second distributed phase, on the same shards, held to phase 4's
    # and the structured phase's results
    dist2 = dist2_phase(g, kept, dist_ref, smi)
    del kept
    launches["segment_or"] += dist2["launches"]["segment_or"]
    for k in ("segment_mode", "run_sum"):
        sm_row["launches"] += dist2["launches"][k]
        sm_row["entry_launches"][k] += dist2["launches"][k]
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
    del seg
    torch.cuda.empty_cache()

    # -- 7. model serving: qwen3-14b at full width through B6, then MLA ----
    model = model_phase(args, smi)
    model["mla"] = mla_phase(smi)
    launches["flash_attention"] += model["b6_launches"]["flash_attention"]
    timed["flash_attention"]["cases"].append(dict(
        shape=f"{MODEL_ARCH} serving {MODEL_BATCH} x {MODEL_PROMPT} + "
              f"{MODEL_GEN} (model path)",
        launches=model["b6_launches"], b6_wall_share=model["b6_wall_share"],
        b6_device_share=model["b6_device_share"],
        b6_ms_per_step=model["b6_ms_per_step"]))

    # -- 8. training: B4 under autograd on the GNN path ---------------------
    torch.cuda.empty_cache()
    train = train_phase(args, smi)
    launches["segment_sum"] += train["b4_launches"]
    gin = train["gin"]
    timed["segment_sum"].setdefault("cases", []).append(dict(
        shape=f"gin-tu {GIN_SHAPE} training, {GIN_STEPS} steps (training "
              f"path; launches also from the smoke and molecule steps)",
        launches=train["b4_launches"], launches_per_step=gin["b4"],
        kinds=gin["kinds"], profiled_step=gin["profile"],
        ms_per_step=gin["b4_ms_per_step"],
        bound_ms_per_step=gin["b4_bound_ms_per_step"],
        strict_bound_ms_per_step=gin["b4_strict_bound_ms_per_step"],
        library_ms_per_step=gin["b4_library_ms_per_step"],
        gather_ms_profiled=gin["profile"]["gather_ms"],
        max_abs_err=max(c["err"] for c in gin["calls"])))
    err["segment_sum"] = max(err["segment_sum"],
                             max(c["err"] for c in gin["calls"]))

    # -- 9. training over a process mesh: B4 at the owners ------------------
    torch.cuda.empty_cache()
    meshed = mesh_phase(smi)
    launches["segment_sum"] += meshed["b4_launches"]
    timed["segment_sum"]["cases"].append(dict(
        shape=f"gin-tu over {MESH_RANKS} ranks (gloo, one card), "
              f"uniform_random_graph({MESH_NODES}, {MESH_DEGREE}), "
              f"{MESH_STEPS} steps, and fm (mesh path: the owner-side sums)",
        launches=meshed["b4_launches"],
        launches_per_rank_per_step=[[st["b4"] for st in r["steps"]]
                                    for r in meshed["ranks"]],
        ms_per_rank_per_step=[[st["b4_ms"] for st in r["steps"]]
                              for r in meshed["ranks"]]))

    # -- 10. the LM over a process mesh: B6 on each rank's heads ----------
    torch.cuda.empty_cache()
    lmmesh = lmmesh_phase(smi, {"bf16": train["lm"]["losses"][0],
                                "f32": train["lm"]["f32"]["losses"][0]})
    launches["flash_attention"] += lmmesh["b6_launches"]
    timed["flash_attention"]["cases"].append(dict(
        shape=f"{MODEL_ARCH} served over {LMMESH_SERVE_GRID} ranks (gloo, "
              f"one card), {MODEL_BATCH} x {MODEL_PROMPT} + {MODEL_GEN} "
              f"(mesh path: each rank's heads)",
        launches=lmmesh["b6_launches"],
        launches_per_rank=[r["serve"]["b6"] for r in lmmesh["ranks"]],
        max_abs_err_row=max(r["b6_checked"]["row_err"]
                            for r in lmmesh["ranks"])))

    # -- 11. the dry run against this run's card numbers; the examples ----
    torch.cuda.empty_cache()
    dry = dryrun_phase(smi, model, train, meshed, lmmesh)

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
                   "dist": dist, "dist2": dist2, "model": model,
                   "train": train, "mesh": meshed, "lmmesh": lmmesh,
                   "dryrun": dry,
                   "sparse_min_ms": sparse_min_ms, "heaviest_block": heavy,
                   "tune": tuned,
                   "total_s": time.perf_counter() - t_all}, fh, indent=1)
    left = descendants()
    if left:
        fail(f"processes this run started are still running: {left}")
    log("[procs] every process this run started has ended")
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
