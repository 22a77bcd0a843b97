#!/usr/bin/env python3
"""The EmbeddingBag kernel (B5) of this checkout against that of another
checkout, in turns on one card: old, new, new, old.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/pair_embedding_bag.py --parent build/parent [--reps 20]

Builds ``src/repro_torch/csrc/embedding_bag.cu`` of both checkouts and times
both on the fm serving inputs of ``chip_smoke.py`` (39 fields x 1,000,000
rows, one (39,000,064, 11) f32 table, Zipf(1.2) ids, one bag per sample):
``serve_bulk`` batch 262,144 'sum', the same batch as a weighted 'mean' with
10% of ids -1, and ``serve_p99`` batch 512 'sum'.  This checkout's kernel is
called through its wrapper ``embedding_bag_kernel_call`` on the bag-sorted
stream; the other one through the C interface of the first design
(``embedding_bag(table, idx, w, offsets, out, n_bags, d, n_rows, mean,
stream)``) with the offsets built as its wrapper built them
(``torch.searchsorted``), inside the timed call.  Prints the card's name and
power limit, for each case the largest |new - old| and the paired times
(and the old kernel alone, its offsets built beforehand), and last one JSON
line with every number.  Needs a card.
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

# each kernel within 1e-5 of the float64 plain version (chip_smoke.py's
# BAG_TOL), so within twice that of each other
PAIR_TOL = 2e-5


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


def fm_inputs(batch: int, gen, seed: int = 12):
    """The fm serving stream of ``chip_smoke.py`` phase 6: table (V, 11),
    idx and bag (39 * batch,) int32 sorted by bag."""
    import numpy as np
    import torch
    n_fields, per_field, d = 39, 1_000_000, 11
    v_rows = -(-n_fields * per_field // 512) * 512
    table = torch.randn(v_rows, d, device="cuda", generator=gen)
    rng = np.random.default_rng(seed)
    local = rng.zipf(1.2, size=(batch, n_fields)) % per_field
    ids = (local + np.arange(n_fields)[None, :] * per_field).astype(np.int32)
    idx = torch.from_numpy(ids.reshape(-1)).cuda()
    bag = torch.arange(batch, dtype=torch.int32, device="cuda"
                       ).repeat_interleave(n_fields)
    return table, idx, bag


def load_parent(parent: str) -> ctypes.CDLL:
    """The other checkout's embedding_bag.cu, built with this checkout's
    flags."""
    from repro_torch.kernels import _build
    src = os.path.join(parent, "src", "repro_torch", "csrc",
                       "embedding_bag.cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    out = os.path.join(ROOT, "build", "pair",
                       f"embedding_bag-parent-{digest}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if not os.path.exists(out):
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # table, idx, w, offsets, out, n_bags, d, n_rows, mean, stream
    lib.embedding_bag.argtypes = [P, P, P, P, P, L, I, L, I, P]
    lib.embedding_bag.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("pair_embedding_bag: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import embedding_bag as EB

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[pair] {smi}", flush=True)
    old_lib = load_parent(args.parent)
    EB._lib()
    gen = torch.Generator(device="cuda").manual_seed(12)
    table, idx, bag = fm_inputs(262_144, gen)
    idx_pad = torch.where(torch.rand(idx.numel(), device="cuda",
                                     generator=gen) < 0.1, -1, idx)
    w = torch.rand(idx.numel(), device="cuda", generator=gen)
    _, idx_p99, bag_p99 = fm_inputs(512, gen)
    cases = [  # label, idx, bag, n_bags, weights, mode
        ("fm serve_bulk sum", idx, bag, 262_144, None, "sum"),
        ("fm serve_bulk weighted mean, 10% ids -1", idx_pad, bag, 262_144, w,
         "mean"),
        ("fm serve_p99 sum", idx_p99, bag_p99, 512, None, "sum")]
    d, n_rows = table.shape[1], table.shape[0]
    rows = []
    for label, ix, bg, n_bags, wt, mode in cases:
        def offsets():
            return torch.searchsorted(bg, torch.arange(
                n_bags + 1, dtype=bg.dtype, device="cuda"))

        def old_kernel(off):
            out = torch.empty(n_bags, d, device="cuda")
            _build.launch(old_lib.embedding_bag, table.device,
                          table.data_ptr(), ix.data_ptr(),
                          None if wt is None else wt.data_ptr(),
                          off.data_ptr(), out.data_ptr(), n_bags, d, n_rows,
                          int(mode == "mean"), what="parent")
            return out

        def old():
            return old_kernel(offsets())

        def new():
            return EB.embedding_bag_kernel_call(table, ix, bg, n_bags, wt,
                                                mode=mode)

        want, got = old(), new()
        torch.cuda.synchronize()
        diff = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=PAIR_TOL, atol=PAIR_TOL):
            print(f"pair_embedding_bag: {label}: the two kernels disagree "
                  f"(max |new - old| {diff!r})", file=sys.stderr)
            return 1
        del want, got
        off = offsets()
        o1 = cuda_ms(old, args.reps)
        n1 = cuda_ms(new, args.reps)
        n2 = cuda_ms(new, args.reps)
        o2 = cuda_ms(old, args.reps)
        old_alone = cuda_ms(lambda: old_kernel(off), args.reps)
        rows.append(dict(case=label, n_lookups=ix.numel(), n_bags=n_bags,
                         max_abs_diff=diff, old_ms=[o1, o2], new_ms=[n1, n2],
                         old_kernel_alone_ms=old_alone,
                         speedup=(o1 + o2) / (n1 + n2)))
        print(f"[pair] {label}: old {o1!r} / {o2!r} ms, new {n1!r} / "
              f"{n2!r} ms (old, new, new, old), {rows[-1]['speedup']!r}x; "
              f"old kernel alone {old_alone!r} ms; max |new - old| "
              f"{diff!r}", flush=True)
    print(json.dumps({"device": smi, "pairs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
