#!/usr/bin/env python3
"""Where the time of the EmbeddingBag call (B5) goes, on one card.

    python3 scripts/profile_embedding_bag.py [--root .] [--reps 20]

Builds ``src/repro_torch/csrc/embedding_bag.cu`` of the checkout at
``--root`` (this one by default; another checkout unpacked with ``git
archive`` profiles that tree's wrapper), makes the fm serving inputs of
``chip_smoke.py`` (39 fields x 1,000,000 rows, one (39,000,064, 11) f32
table, Zipf(1.2) ids, ``serve_bulk`` batch 262,144 and ``serve_p99`` batch
512, one bag per sample) and runs under ``torch.profiler``:

- the kernel wrapper ``embedding_bag_kernel_call`` on the bag-sorted stream,
  'sum', the weighted 'mean' with 10% of ids -1, and 'sum' at ``serve_p99``
  batch 512;
- the entry point ``ops.embedding_bag``, which adds one sentinel per bag and
  sorts the stream first, at both batches.

For each call it prints the host time of one call (the enqueue, no
synchronisation), the device time per call of every kernel the call
launches (the offsets step, the bag kernel and its passes, the sort), and
their sum; last one JSON line with every number.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fm_inputs(batches, seed: int = 12):
    """The fm serving inputs of ``chip_smoke.py`` phase 6: the (V, 11)
    table, a torch generator, and for each batch size an idx and a bag
    stream (39 lookups a sample, sorted by bag) drawn in turn from one
    numpy generator."""
    import numpy as np
    import torch
    n_fields, per_field, d = 39, 1_000_000, 11
    v_rows = -(-n_fields * per_field // 512) * 512
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.randn(v_rows, d, device="cuda", generator=gen)
    rng = np.random.default_rng(seed)
    streams = []
    for batch in batches:
        local = rng.zipf(1.2, size=(batch, n_fields)) % per_field
        ids = (local + np.arange(n_fields)[None, :] * per_field).astype(
            np.int32)
        streams.append((torch.from_numpy(ids.reshape(-1)).cuda(),
                        torch.arange(batch, dtype=torch.int32, device="cuda"
                                     ).repeat_interleave(n_fields)))
    return table, gen, streams


def device_us(event) -> float:
    """An event's own device time in microseconds, under either of the
    attribute names torch has used."""
    for key in ("self_device_time_total", "self_cuda_time_total"):
        t = getattr(event, key, None)
        if t is not None:
            return float(t)
    return 0.0


def profile_call(fn, reps: int):
    """(host ms per call, {kernel name: device ms per call})."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        us = device_us(ev)
        if us > 0 and not ev.key.startswith("aten::"):
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us / reps / 1e3
    return host, kernels, prof


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="root of the checkout whose wrapper is profiled")
    ap.add_argument("--batch", type=int, default=262_144)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import torch
    if not torch.cuda.is_available():
        print("profile_embedding_bag: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import embedding_bag as EB

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[profile] {smi}; checkout {os.path.abspath(args.root)}")
    lib, ptxas = _build.compile_source("embedding_bag")
    print(f"[build] {lib.name}")
    for line in ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line or \
                "spill" in line or "smem" in line:
            print(f"[build]   {line.strip()}")
    batch, batch_p99 = args.batch, 512
    table, gen, ((idx, bag), (idx_p99, bag_p99)) = fm_inputs(
        (batch, batch_p99))
    idx_pad = torch.where(torch.rand(idx.numel(), device="cuda",
                                     generator=gen) < 0.1, -1, idx)
    w = torch.rand(idx.numel(), device="cuda", generator=gen)
    calls = {
        "wrapper sum": lambda: EB.embedding_bag_kernel_call(
            table, idx, bag, batch),
        "wrapper weighted mean, 10% ids -1": lambda:
            EB.embedding_bag_kernel_call(table, idx_pad, bag, batch, w,
                                         mode="mean"),
        "wrapper serve_p99 sum": lambda: EB.embedding_bag_kernel_call(
            table, idx_p99, bag_p99, batch_p99),
        "entry point sum (sentinels and sort)": lambda: ops.embedding_bag(
            table, idx, bag, batch),
        "entry point serve_p99 sum": lambda: ops.embedding_bag(
            table, idx_p99, bag_p99, batch_p99),
    }
    rows = []
    for label, fn in calls.items():
        host, kernels, prof = profile_call(fn, args.reps)
        total = sum(kernels.values())
        print(f"[profile] {label}: host {host!r} ms per call; device "
              f"{total!r} ms per call over {len(kernels)} kernels")
        for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1]):
            print(f"[profile]   {ms!r} ms  {name}")
        print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                        row_limit=12))
        rows.append(dict(call=label, host_ms=host, device_ms=total,
                         kernels=kernels))
    print(json.dumps({"device": smi, "root": os.path.abspath(args.root),
                      "batch": batch, "calls": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
