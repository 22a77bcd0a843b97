#!/usr/bin/env python3
"""Smoke run of the torch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--scale 20] [--out build/chip_smoke.json]

Phases, each of which exits non-zero on failure:

1. device: the card's name, capability, and its name and power limit as
   ``nvidia-smi`` reports them;
2. build: compiles ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a);
3. kernel parity on an RMAT graph (``rmat(scale, 16, seed=7)``, default
   256/512/512 tile geometry): each BBCSR kernel against its plain torch
   version on the card — SpMV (B1), SpMSpV 'add' on a frontier touching
   about 1% of the column blocks (B2), SpMSpV 'min' / 'max' all-active and
   sparse (B3); min/max exact, 'add' within rtol 1e-5 / atol 1e-5;
4. the main path through the port's public entry points, each path with
   the launch counts zeroed just before it and read just after: SpMV,
   BFS on the unit pull operand, SSSP on the (min,+) operand (both against
   the plain engine, bit-equal), PageRank (mass 1 within 1e-3) and
   connected components;
5. kernel timings with CUDA events beside their byte bound, the plain
   version and, where one exists, a library call computing the same
   function (timed here only; the port never calls it).

Prints one JSON line ``{"kernels": [...]}`` and, last, the device line.
Needs one card; on a host without one it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
ADD_RTOL = ADD_ATOL = 1e-5         # kernel vs plain, f32 'add'
SOURCE = "src/repro_torch/csrc/bbcsr.cu"
REPLACES = {"spmv_bbcsr": "src/repro/kernels/spmv_dma.py:206",
            "spmspv_bbcsr_add": "src/repro/kernels/spmv_dma.py:235",
            "spmspv_bbcsr_select": "src/repro/kernels/spmv_dma.py:235"}


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "chip_smoke.json"),
                    help="where to write the run's numbers as JSON")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a card")
    from repro_torch.core import engine, rmat
    from repro_torch.core.algorithms import (bfs, connected_components,
                                             pagerank, spmv, spmv_bbcsr, sssp,
                                             sssp_program, auto_delta)
    from repro_torch.kernels import _build, ref
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

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, ptxas = _build.compile_source("bbcsr")
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")

    # -- graph ---------------------------------------------------------------
    t0 = time.perf_counter()
    g = rmat(args.scale, 16, seed=7)
    torch.cuda.synchronize()
    n = g.n_rows
    log(f"[graph] rmat({args.scale}, 16, seed=7): n={n} nnz={g.nnz} "
        f"in {time.perf_counter() - t0:.2f} s")
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

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand(n, device="cuda", generator=gen)
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
    del lib_mat

    # -- 4. main path ----------------------------------------------------------
    launches = dict.fromkeys(K.LAUNCHES, 0)
    walls, path_launches = {}, {}

    def path(label, fn):
        """Run one query with the launch counts zeroed before it and read
        after it, then once more for a warm wall time (not counted)."""
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        path_launches[label] = dict(K.LAUNCHES)
        for k, v in K.LAUNCHES.items():
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
    del bb_u
    torch.cuda.empty_cache()
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
    del bb_m
    torch.cuda.empty_cache()
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
    log(f"[mem] peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    for k in ("spmv_bbcsr", "spmspv_bbcsr_add", "spmspv_bbcsr_select"):
        if launches[k] == 0:
            fail(f"kernel {k} was not launched on the main path")

    kernels = [dict(name=k, route="cuda", source=SOURCE, replaces=REPLACES[k],
                    launches=launches[k], max_abs_err=err[k],
                    ms=timed[k]["ms"], plain_ms=timed[k]["plain_ms"],
                    bound_ms=timed[k]["bound_ms"], bound_by="bytes",
                    library_ms=timed[k]["library_ms"])
               for k in ("spmv_bbcsr", "spmspv_bbcsr_add",
                         "spmspv_bbcsr_select")]
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"device": name, "nvidia_smi": smi, "scale": args.scale,
                   "kernels": kernels, "walls_s": walls,
                   "sparse_min_ms": sparse_min_ms,
                   "total_s": time.perf_counter() - t_all}, fh, indent=1)
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
