#!/usr/bin/env python3
"""``csrc/segment_mode.cu`` (the weighted mode and the in-order run sums) of
this checkout against that of another checkout, in turns on one card: old,
new, new, old.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/pair_segment_mode.py --parent build/parent [--reps 5]

Builds both checkouts' ``segment_mode.cu``.  The other checkout's entries
are called through the first design's C interface (``segment_mode(dst,
label, w, m, n, ptr, best_w, best_l, stream)``, ``run_sum`` /
``run_sum_f64(idx, w, m, n, ptr, out, stream)``), this checkout's through
its wrapper.  The streams are those ``chip_smoke.py`` times, on
``rmat(20, 16, seed=7)``: the LPA dense step's (destination, label)-sorted
stream after ``label_propagation(iters=8)``, for ``segment_mode``; and
``graph.contract``'s stream of coarse edges under ``multilevel``'s labels,
for ``run_sum`` in f32 and in f64.  Each pair must give equal bits.  Then
one warm ``multilevel`` of each tree under ``torch.profiler``, one
subprocess per turn (old, new, new, old), each running ``--profile-of
ROOT``: its wall and the device time of each of ``segment_mode.cu``'s
kernels inside it.  Prints the card's name and power limit, each pair and
profile, and last one JSON line with every number.  Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE, LPA_ITERS = 20, 8
# the kernels of either design's segment_mode.cu, by their names
KERNELS = ("run_bounds", "sum_walk", "mode_walk", "run_tiles", "mode_pick")


def cuda_ms(fn, reps: int) -> float:
    import torch
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
    """The other checkout's segment_mode.cu, built with this checkout's
    flags."""
    from repro_torch.kernels import _build
    src = os.path.join(parent, "src", "repro_torch", "csrc",
                       "segment_mode.cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    out = os.path.join(ROOT, "build", "pair",
                       f"segment_mode-parent-{digest}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if not os.path.exists(out):
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.segment_mode.argtypes = [P, P, P, L, I, P, P, P, P]
    lib.segment_mode.restype = ctypes.c_int
    for fn in (lib.run_sum, lib.run_sum_f64):
        fn.argtypes = [P, P, L, I, P, P, P]
        fn.restype = ctypes.c_int
    return lib


def device_ms_by_kernel(fn) -> tuple:
    """(device ms of each of ``segment_mode.cu``'s kernels, with its
    launches, and of everything) in one call of ``fn`` under
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, device_us = {}, 0.0
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue   # host records carry their children's device time
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        device_us += us
        for k in KERNELS:
            if k in e.key:
                got = kernels.setdefault(k, {"device_ms": 0.0, "calls": 0})
                got["device_ms"] += us / 1e3
                got["calls"] += e.count
    return kernels, device_us / 1e3


def profile_multilevel(root: str) -> dict:
    """One warm ``multilevel`` of RMAT-20 in the checkout at ``root`` (this
    process imports its package) under ``torch.profiler``: its wall (host
    clock ending in a synchronize) and the device time of each kernel of
    ``segment_mode.cu``, with their launches."""
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.core import rmat
    from repro_torch.core.algorithms import multilevel
    g = rmat(SCALE, 16, seed=7)
    multilevel(g)                                   # builds and warms
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, scores = multilevel(g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels, device_ms = device_ms_by_kernel(lambda: multilevel(g))
    return {"root": root, "wall_s": wall, "scores": scores,
            "labels_digest": hashlib.sha256(
                labels.cpu().numpy().tobytes()).hexdigest()[:16],
            "device_ms": device_ms, "kernels": kernels}


def streams():
    """The LPA dense step's stream (dst, label, w, n) and contract's
    stream (run ids, weights, runs) on RMAT-20, on the card."""
    import torch
    from repro_torch.core import offload, rmat
    from repro_torch.core.algorithms import label_propagation, multilevel
    g = rmat(SCALE, 16, seed=7)
    n = g.n_rows
    lpa = label_propagation(g, iters=LPA_ITERS)
    t_g = g.transpose()
    rows_t, cols_t = t_g.index64()
    key, order = torch.sort((cols_t << 32) | lpa[rows_t].long(), stable=True)
    mode = (key >> 32, key & 0xFFFFFFFF, t_g.values[order], n)
    del t_g, rows_t, cols_t, key, order
    ml, _ = multilevel(g)
    rows, cols = g.index64()
    dense, _ = offload.compact_labels(ml)
    key, order = torch.sort((dense[rows].long() << 32) | dense[cols].long(),
                            stable=True)
    _, run_id = offload.run_starts(key)
    runs = (run_id, g.values[order], int(run_id[-1]) + 1)
    return mode, runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile-of", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("pair_segment_mode: needs a CUDA card", file=sys.stderr)
        return 1
    if args.profile_of:
        print(json.dumps(profile_multilevel(args.profile_of)))
        return 0
    if not args.parent:
        ap.error("--parent is required")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import segment_mode as SM

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[pair] {smi}", flush=True)
    old_lib = load_parent(args.parent)
    (dst, lab, sw, n), (run_id, sv, n_runs) = streams()

    # the int64 streams cast inside the call, as the old wrapper did
    def old_mode():
        dst32, lab32 = dst.to(torch.int32), lab.to(torch.int32)
        bw = torch.empty(n, device="cuda")
        bl = torch.empty(n, dtype=torch.int32, device="cuda")
        ptr = torch.empty(n + 1, dtype=torch.int64, device="cuda")
        _build.launch(old_lib.segment_mode, bw.device, dst32.data_ptr(),
                      lab32.data_ptr(), sw.data_ptr(), dst32.numel(), n,
                      ptr.data_ptr(), bw.data_ptr(), bl.data_ptr(),
                      what="parent segment_mode")
        return bw, bl

    def old_sum(w):
        run32 = run_id.to(torch.int32)
        out = torch.empty(n_runs, dtype=w.dtype, device="cuda")
        ptr = torch.empty(n_runs + 1, dtype=torch.int64, device="cuda")
        fn = old_lib.run_sum_f64 if w.dtype == torch.float64 else \
            old_lib.run_sum
        _build.launch(fn, w.device, run32.data_ptr(), w.data_ptr(),
                      run32.numel(), n_runs, ptr.data_ptr(), out.data_ptr(),
                      what="parent run_sum")
        return out

    rows = []

    def turns(label, old, new, extra):
        a, b = old(), new()
        torch.cuda.synchronize()
        a, b = (a if isinstance(a, tuple) else (a,),
                b if isinstance(b, tuple) else (b,))
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            print(f"pair_segment_mode: {label}: the two trees disagree",
                  file=sys.stderr)
            sys.exit(1)
        del a, b
        o1 = cuda_ms(old, args.reps)
        n1 = cuda_ms(new, args.reps)
        n2 = cuda_ms(new, args.reps)
        o2 = cuda_ms(old, args.reps)
        rows.append(dict(case=label, old_ms=[o1, o2], new_ms=[n1, n2],
                         speedup=(o1 + o2) / (n1 + n2), **extra))
        print(f"[pair] {label}: old {o1!r} / {o2!r} ms, new {n1!r} / {n2!r} "
              f"ms (old, new, new, old), {rows[-1]['speedup']!r}x; {extra}; "
              f"equal bits", flush=True)

    longest = int(torch.bincount(run_id).max())
    _, mode_run = torch.unique_consecutive((dst << 32) | lab,
                                           return_counts=True)
    new_mode = lambda: SM.segment_mode_kernel_call(dst, lab, sw, n)
    turns("segment_mode on LPA's stream", old_mode, new_mode,
          {"items": dst.numel(), "destinations": n,
           "longest_run": int(mode_run.max()),
           "new_by_kernel": device_ms_by_kernel(new_mode)[0]})
    sv64 = sv.double()
    for w, tag in ((sv, "f32"), (sv64, "f64")):
        new_sum = lambda: SM.run_sum_kernel_call(run_id, w, n_runs)
        turns(f"run_sum ({tag}) on contract's stream", lambda: old_sum(w),
              new_sum, {"items": run_id.numel(), "runs": n_runs,
                        "longest_run": longest,
                        "new_by_kernel": device_ms_by_kernel(new_sum)[0]})
    del dst, lab, sw, run_id, sv, sv64
    torch.cuda.empty_cache()

    profiles = []
    for root in (args.parent, ROOT, ROOT, args.parent):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--profile-of", root],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"pair_segment_mode: the profile of {root} failed:\n"
                  f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}",
                  file=sys.stderr)
            return 1
        profiles.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        tree = "old" if root == args.parent else "new"
        p = profiles[-1]
        print(f"[pair] multilevel rmat-{SCALE}, {tree} tree: wall "
              f"{p['wall_s']!r} s, device {p['device_ms']!r} ms, "
              f"segment_mode.cu kernels {p['kernels']}, scores "
              f"{p['scores']}", flush=True)
    if len({(p["labels_digest"], tuple(p["scores"])) for p in profiles}) != 1:
        print("pair_segment_mode: the trees' multilevel results differ",
              file=sys.stderr)
        return 1
    print(json.dumps({"device": smi, "pairs": rows, "profiles": profiles}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
