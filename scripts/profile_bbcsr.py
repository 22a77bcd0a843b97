#!/usr/bin/env python3
"""Device time of each kernel behind the port's BBCSR products, on one card.

    python3 scripts/profile_bbcsr.py [--scale 20] [--reps 20]

Builds ``csrc/bbcsr.cu`` (printing what ptxas reports for it), the RMAT
pull operand of ``chip_smoke.py`` and its 1% frontier, then runs SpMV (B1),
SpMSpV 'add' on the frontier (B2) and SpMSpV 'min' all active and on the
frontier (B3) under ``torch.profiler``, and prints the device time of
every kernel launched over the calls (the plan passes, the product, the
fixup) and the host time of the wrapper; then the plan alone, and a gather
of the live slots where the padded layout puts them against the same
gather from the slots packed.  Needs a card.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_bbcsr: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine, rmat
    from repro_torch.kernels import _build
    from repro_torch.kernels import spmv_dma as K

    lib, ptxas = _build.compile_source("bbcsr")
    print(f"[build] {lib.name}")
    for line in ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line or \
                "spill" in line or "smem" in line:
            print(f"[build]   {line.strip()}")
    g = rmat(args.scale, 16, seed=7)
    bb = engine.build_pull_operand(g)
    n = g.n_rows
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand(n, device="cuda", generator=gen)
    n_cb = bb.n_col_blocks
    blocks = torch.randperm(n_cb, device="cuda", generator=gen)[
        :max(1, n_cb // 100)]
    offs = torch.randint(0, bb.block_cols, (blocks.numel(), 8), device="cuda",
                         generator=gen)
    ids = (blocks[:, None] * bb.block_cols + offs).reshape(-1)
    frontier = torch.zeros(n, dtype=torch.int32, device="cuda")
    frontier[ids[ids < n]] = 1
    act = engine.tile_active(bb, frontier)
    all_act = torch.ones(bb.n_tiles, dtype=torch.int32, device="cuda")
    x_sp = torch.where(frontier > 0, x, 0.0)
    x_min = torch.where(frontier > 0, x, float("inf"))
    calls = {
        "B1 spmv": lambda: K.spmv_bbcsr_kernel_call(bb, x),
        "B2 spmspv add 1%": lambda: K.spmspv_bbcsr_kernel_call(bb, x_sp, act),
        "B3 min all active": lambda: K.spmspv_bbcsr_kernel_call(
            bb, x, all_act, combine="min"),
        "B3 min 1%": lambda: K.spmspv_bbcsr_kernel_call(
            bb, x_min, act, combine="min"),
    }
    for label, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn()
        host = (time.perf_counter() - t0) / args.reps
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        print(f"[profile] {label}: host enqueue {1e3 * host!r} ms per call;"
              f" {args.reps} calls below")
        print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                        row_limit=10))
    for label, a in (("dense", None), ("all active", all_act),
                     ("1%", act)):
        print(f"[plan] plan alone, {label}: "
              f"{cuda_ms(lambda: K.plan(bb, a), args.reps)!r} ms")
    # what the padded layout costs to read: index_select of the three tile
    # arrays through the live slots' flat indices (a tile's live slots are
    # the head of its tile_nnz-wide row), against the same gather from the
    # live slots packed; both read the same indices and write the same
    # output, so the difference is where the slots lie
    slot = torch.arange(bb.tile_nnz, device="cuda")
    idx = torch.nonzero((slot[None, :] < bb.tile_cnt[:, None]).view(-1)
                        ).squeeze(1)
    flat = [t.view(-1) for t in (bb.rows_local, bb.cols_local, bb.vals)]
    packed = [f.index_select(0, idx) for f in flat]
    seq = torch.arange(idx.numel(), device="cuda")
    in_place = cuda_ms(lambda: [f.index_select(0, idx) for f in flat],
                       args.reps)
    together = cuda_ms(lambda: [f.index_select(0, seq) for f in packed],
                       args.reps)
    print(f"[layout] gather the {idx.numel()} live slots of the 3 tile "
          f"arrays: where they lie {in_place!r} ms, packed {together!r} ms")
    return 0


def cuda_ms(fn, reps: int) -> float:
    import torch
    for _ in range(2):
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


if __name__ == "__main__":
    sys.exit(main())
