#!/usr/bin/env python3
"""The BBCSR kernels of this checkout against those of another checkout, in
turns on one card: old, new, new, old.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/pair_bbcsr.py --parent build/parent [--scale 20]

Builds ``src/repro_torch/csrc/bbcsr.cu`` of both checkouts, the RMAT pull
operand and 1% frontier of ``chip_smoke.py``, checks that both give the same
results (min / max bit-equal, 'add' within rtol / atol 1e-5), and prints the
paired times of SpMV (B1), SpMSpV 'add' on the frontier (B2) and SpMSpV 'min'
all active and on the frontier (B3), with the card's name and power limit.
The other checkout's kernels are called through the C interface of the
first design's ``bbcsr.cu`` (one CTA per row block, x padded by the
caller: ``bbcsr_spmv``, ``bbcsr_spmspv_add``, ``bbcsr_spmspv_select``).
Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


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


def load_parent(parent: str) -> ctypes.CDLL:
    """The other checkout's bbcsr.cu, built with this checkout's flags."""
    from repro_torch.kernels import _build
    src = os.path.join(parent, "src", "repro_torch", "csrc", "bbcsr.cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    out = os.path.join(ROOT, "build", "pair", f"bbcsr-parent-{digest}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if not os.path.exists(out):
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bbcsr_spmv.argtypes = [P] * 8 + [I] * 5 + [P]
    lib.bbcsr_spmspv_add.argtypes = [P] * 9 + [I] * 5 + [P]
    lib.bbcsr_spmspv_select.argtypes = [P] * 9 + [I] * 6 + [P]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="root of the other checkout")
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("pair_bbcsr: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core import engine, rmat
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import spmv_dma as K

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[pair] {smi}")
    old_lib = load_parent(args.parent)
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
    tiles = [bb.rows_local, bb.cols_local, bb.vals, bb.tile_cb, bb.tile_cnt]
    geom = [bb.n_rows, bb.n_row_blocks, bb.block_rows, bb.block_cols,
            bb.tile_nnz]

    def old(xv, a, combine):
        x_pad = ref.pad_x(bb, xv, ref.combine_identity(combine))
        y = torch.empty(bb.n_rows, device="cuda")
        mid = [] if a is None else [a]
        ptrs = [t.data_ptr() for t in (*tiles, *mid, bb.rb_ptr, x_pad, y)]
        if a is None:
            fn, extra = old_lib.bbcsr_spmv, []
        elif combine == "add":
            fn, extra = old_lib.bbcsr_spmspv_add, []
        else:
            fn, extra = old_lib.bbcsr_spmspv_select, [1]
        _build.launch(fn, xv.device, *ptrs, *geom, *extra, what="parent")
        return y

    def new(xv, a, combine):
        if a is None:
            return K.spmv_bbcsr_kernel_call(bb, xv)
        return K.spmspv_bbcsr_kernel_call(bb, xv, a, combine=combine)

    for label, xv, a, comb in (("B1 spmv", x, None, "add"),
                               ("B2 spmspv add 1%", x_sp, act, "add"),
                               ("B3 spmspv min all active", x, all_act,
                                "min"),
                               ("B3 spmspv min 1%", x_min, act, "min")):
        want, got = old(xv, a, comb), new(xv, a, comb)
        torch.cuda.synchronize()
        same = torch.equal(got, want) if comb != "add" else \
            torch.allclose(got, want, rtol=1e-5, atol=1e-5)
        if not same:
            print(f"pair_bbcsr: {label}: the two kernels disagree",
                  file=sys.stderr)
            return 1
        o1 = cuda_ms(lambda: old(xv, a, comb), args.reps)
        n1 = cuda_ms(lambda: new(xv, a, comb), args.reps)
        n2 = cuda_ms(lambda: new(xv, a, comb), args.reps)
        o2 = cuda_ms(lambda: old(xv, a, comb), args.reps)
        print(f"[pair] {label}: old {o1!r} / {o2!r} ms, new {n1!r} / "
              f"{n2!r} ms (old, new, new, old)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
