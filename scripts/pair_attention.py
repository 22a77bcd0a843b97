#!/usr/bin/env python3
"""The flash attention kernel (B6) of this checkout against that of another
checkout, in turns on one card: old, new, new, old.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/pair_attention.py --parent build/parent [--reps 20]

Builds ``src/repro_torch/csrc/flash_attention.cu`` of both checkouts and
times both at the B6 shapes of ``chip_smoke.py`` (bf16, D 128): qwen3-14b
prefill 4096 causal, qwen3-14b decode at batch 128 and at batch 1 over a
32,768-key cache, and mixtral-8x7b's 4096-token window over 8192.  This
checkout's kernel is called through ``repro_torch.kernels.ops``; the other
one through the C interface of the first design (``flash_attention_fwd``
with the folded tile block_q 64 / block_k 64, its defaults).  Prints the
card's name and power limit, for each shape the bf16 agreement of the two
(largest per-row ||new - old|| / ||old|| and largest |new - old|) and the
paired times, and last one JSON line with every number.  Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SHAPES = [  # label, B, Hq, Hkv, Sq, Skv, window
    ("qwen3-14b prefill", 1, 40, 8, 4096, 4096, None),
    ("qwen3-14b decode", 128, 40, 8, 1, 32768, None),
    ("mixtral-8x7b window", 1, 32, 8, 8192, 8192, 4096),
    ("qwen3-14b decode batch 1", 1, 40, 8, 1, 32768, None)]


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
    """The other checkout's flash_attention.cu, built with this checkout's
    flags."""
    from repro_torch.kernels import _build
    src = os.path.join(parent, "src", "repro_torch", "csrc",
                       "flash_attention.cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    out = os.path.join(ROOT, "build", "pair",
                       f"flash_attention-parent-{digest}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if not os.path.exists(out):
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    # q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, window, scale, block_q,
    # block_k, bf16, stream
    lib.flash_attention_fwd.argtypes = [P] * 4 + [I] * 8 + [
        ctypes.c_float, I, I, I, P]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("pair_attention: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as FA

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[pair] {smi}", flush=True)
    old_lib = load_parent(args.parent)
    FA._lib()
    gen = torch.Generator(device="cuda").manual_seed(14)
    D = 128
    rows = []
    for label, B, Hq, Hkv, Sq, Skv, window in SHAPES:
        q, k, v = (torch.randn(B, h, s, D, device="cuda", generator=gen,
                               dtype=torch.bfloat16)
                   for h, s in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv)))

        def old():
            out = torch.empty_like(q)
            _build.launch(old_lib.flash_attention_fwd, q.device,
                          q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), B, Hq, Hkv, Sq, Skv, D, 1,
                          window or 0, D ** -0.5, 64, 64, 1, what="parent")
            return out

        def new():
            return ops.flash_attention(q, k, v, causal=True, window=window)

        FA.reset_launches()
        want, got = old().float(), new().float()
        torch.cuda.synchronize()
        taken = [key for key in ("flash_attention_wgmma",
                                 "flash_attention_split")
                 if FA.LAUNCHES[key]]
        row = float(((got - want).norm(dim=-1) /
                     want.norm(dim=-1).clamp_min(1e-30)).max())
        diff = float((got - want).abs().max())
        del want, got
        if row > 1e-2:
            print(f"pair_attention: {label}: the two kernels disagree "
                  f"(per row {row!r})", file=sys.stderr)
            return 1
        o1 = cuda_ms(old, args.reps)
        n1 = cuda_ms(new, args.reps)
        n2 = cuda_ms(new, args.reps)
        o2 = cuda_ms(old, args.reps)
        rows.append(dict(shape=label, B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Skv=Skv,
                         window=window, new_path=taken or ["folded"],
                         row_err=row, max_abs_diff=diff, old_ms=[o1, o2],
                         new_ms=[n1, n2], speedup=(o1 + o2) / (n1 + n2)))
        print(f"[pair] {label}: old {o1!r} / {o2!r} ms, new {n1!r} / "
              f"{n2!r} ms (old, new, new, old), {rows[-1]['speedup']!r}x; "
              f"new path {rows[-1]['new_path']}; per row max ||new - old|| "
              f"/ ||old|| {row!r}, max |new - old| {diff!r}", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "pairs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
