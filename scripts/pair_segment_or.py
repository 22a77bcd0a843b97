#!/usr/bin/env python3
"""MS-BFS's dense pull step of this checkout against that of another
checkout, in turns on one card: old, new, new, old.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/pair_segment_or.py --parent build/parent [--reps 20]

The other checkout's step is the gather ``msg[p_src]`` (int64 sources)
followed by its ``csrc/segment_or.cu`` entry ``segment_or(idx, words, out,
m, W, n, stream)`` on a zero-filled ``out``, as its engine ran it; this
checkout's is ``segment_or_rows`` through its wrapper.  Both on the dense
step's stream of ``rmat(20, 16, seed=7)`` at 32 lanes, each turn's bits
equal to the plain version's; the new step's device time split by kernel
(``torch.profiler``).  Then one subprocess per turn (old, new, new, old),
each importing its own checkout (``--turn-of ROOT``): a warm ``msbfs`` over
chip_smoke.py's 32 sources (median of 5 host walls ending in a
synchronize) and a ``GraphService`` flush of 4 Reachability queries a
source (the second of two fresh services; its engine span); levels and
answers must be equal in every turn.  Prints the card's name and power
limit, each pair, and last one JSON line with every number.  Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE, LANES, MSBFS_RUNS = 20, 32, 5
KERNELS = ("segment_or_plan", "segment_or_rows_kernel", "segment_or_kernel")


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
    """The other checkout's segment_or.cu, built with this checkout's
    flags."""
    from repro_torch.kernels import _build
    src = os.path.join(parent, "src", "repro_torch", "csrc", "segment_or.cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    out = os.path.join(ROOT, "build", "pair",
                       f"segment_or-parent-{digest}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if not os.path.exists(out):
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.segment_or.argtypes = [P, P, P, L, I, I, P]
    lib.segment_or.restype = ctypes.c_int
    return lib


def graph_and_sources():
    """rmat(20, 16, seed=7) on the card and chip_smoke.py's batched
    sources: vertex 0, then 31 drawn from the vertices with out-edges."""
    import numpy as np
    from repro_torch.core import rmat
    g = rmat(SCALE, 16, seed=7)
    deg = g.degrees().cpu().numpy()
    sources = np.concatenate([[0], np.random.default_rng(0).choice(
        np.flatnonzero(deg >= 1), LANES - 1, replace=False)]).astype(np.int32)
    return g, sources


def device_ms_by_kernel(fn) -> dict:
    """Device ms and launches of each of ``segment_or.cu``'s kernels in one
    call of ``fn`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        for k in KERNELS:
            if k in e.key:
                got = kernels.setdefault(k, {"device_ms": 0.0, "calls": 0})
                got["device_ms"] += us / 1e3
                got["calls"] += e.count
    return kernels


def turn(root: str) -> dict:
    """A warm msbfs and a service flush in the checkout at ``root`` (this
    process imports its package)."""
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.core import GraphService, Reachability
    from repro_torch.core.algorithms import msbfs
    g, sources = graph_and_sources()
    lv = msbfs(g, sources)                          # builds and warms
    walls = []
    for _ in range(MSBFS_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lv = msbfs(g, sources)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    import numpy as np
    rng = np.random.default_rng(1)
    stream = [Reachability(int(s), int(t)) for s in sources
              for t in rng.integers(0, g.n_rows, 4)]
    flush = []
    for _ in range(2):                              # the second: warm
        svc = GraphService(g, batch_budget=LANES, cache_capacity=4096)
        tickets = [svc.submit(q) for q in stream]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.flush()
        torch.cuda.synchronize()
        flush.append(time.perf_counter() - t0)
        answers = [bool(svc.result(t)) for t in tickets]
    return {"root": root, "msbfs_warm_s": statistics.median(walls),
            "msbfs_walls_s": walls, "flush_s": flush[-1],
            "flush_cold_s": flush[0],
            "levels_digest": hashlib.sha256(
                lv.cpu().numpy().tobytes()).hexdigest()[:16],
            "answers_digest": hashlib.sha256(
                bytes(answers)).hexdigest()[:16]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--turn-of", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("pair_segment_or: needs a CUDA card", file=sys.stderr)
        return 1
    if args.turn_of:
        print(json.dumps(turn(args.turn_of)))
        return 0
    if not args.parent:
        ap.error("--parent is required")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import engine
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import segment_or as SO

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[pair] {smi}", flush=True)
    old_lib = load_parent(args.parent)
    g, _ = graph_and_sources()
    n = g.n_rows
    offsets, src = engine._dst_csr(g)
    p_src, p_dst, _ = engine._dst_sorted(g)
    gen = torch.Generator(device="cuda").manual_seed(16)
    words = torch.randint(-2**31, 2**31, (n, engine.lane_words(LANES)),
                          dtype=torch.int32, device="cuda", generator=gen)
    want = ref.segment_or_rows_ref(offsets, src, words, n)

    def old_step():
        w_e = words[p_src]
        out = torch.zeros((n, w_e.shape[1]), dtype=torch.int32,
                          device="cuda")
        _build.launch(old_lib.segment_or, out.device, p_dst.data_ptr(),
                      w_e.data_ptr(), out.data_ptr(), w_e.shape[0],
                      w_e.shape[1], n, what="parent segment_or")
        return out

    def new_step():
        return SO.segment_or_rows_kernel_call(offsets, src, words, n)

    record = {"device": smi, "m": src.numel(), "n": n,
              "W": words.shape[1], "dense_step_ms": {}, "turns": []}
    for side in ("old", "new", "new", "old"):
        fn = old_step if side == "old" else new_step
        same = torch.equal(fn(), want)
        ms = cuda_ms(fn, args.reps)
        record["dense_step_ms"].setdefault(side, []).append(ms)
        print(f"[pair] dense step {side}: {ms!r} ms, bits equal {same}",
              flush=True)
        if not same:
            print("pair_segment_or: a step disagrees with the plain "
                  "version", file=sys.stderr)
            return 1
    record["new_kernels"] = device_ms_by_kernel(new_step)
    print(f"[pair] new step by kernel: {record['new_kernels']}", flush=True)
    old_ms = statistics.mean(record["dense_step_ms"]["old"])
    new_ms = statistics.mean(record["dense_step_ms"]["new"])
    record["speedup"] = old_ms / new_ms
    print(f"[pair] dense step old / new: {record['speedup']!r}x", flush=True)
    del g, offsets, src, p_src, p_dst, words, want
    torch.cuda.empty_cache()

    for side in ("old", "new", "new", "old"):
        root = args.parent if side == "old" else ROOT
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn-of", os.path.abspath(root)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            return 1
        got = dict(json.loads(out.stdout.strip().splitlines()[-1]),
                   side=side)
        record["turns"].append(got)
        print(f"[pair] {side}: msbfs warm {got['msbfs_warm_s']!r} s, "
              f"service flush {got['flush_s']!r} s (cold "
              f"{got['flush_cold_s']!r} s)", flush=True)
    digests = {(t["levels_digest"], t["answers_digest"])
               for t in record["turns"]}
    print(f"[pair] levels and answers equal in every turn: "
          f"{len(digests) == 1}", flush=True)
    print(json.dumps(record))
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
