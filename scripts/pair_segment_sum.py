#!/usr/bin/env python3
"""B4 (the segment sum) of this checkout against that of another checkout,
in turns on one card: old, new, new, old.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/pair_segment_sum.py --parent build/parent [--reps 10]

Builds ``src/repro_torch/csrc/segment_sum.cu`` of both checkouts.  The other
checkout's B4 is called through the first design's C interface
(``segment_sum(data, seg, out, n, d, m, block_n, stream)``: atomics into an
``out`` the caller zero-fills, block_n 2048, its tuned value) and fed as
that checkout's GNN step fed it: torch gathers the (E, d) messages (the
table with a zero row appended, then one index), then B4 sums them by
segment id.  This checkout's B4 is the CSR kernel with the row gather fused
in, on an ``EdgePlan`` built beforehand, as one forward builds it for all
its layers; the plan's own time is printed apart.  Cases, on gin-tu's
ogb_products cell (``uniform_random_graph(2449029, 25, seed=0)``, padded
with -1 to 61,859,328 edges): GIN's message passing forward at d 100
(layer 0) and d 64, and its backward at d 64; and RMAT-20's in-edges with
sorted ids at d 64 through each checkout's ``segment_sum_sorted`` path (old:
the zero fill and the kernel; new: a plan and the kernel).  Then the warm
gin-tu train step of each tree, one subprocess per turn (old, new, new,
old), each running ``--step-of ROOT``.  Prints the card's name and power
limit, each case's paired times and the largest |new - old|, and last one
JSON line with every number.  Needs a card.
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
OLD_BLOCK_N = 2048
# each side within 1e-4 of the float64 plain version (chip_smoke.py's
# SEG_TOL), so within twice that of each other
PAIR_TOL = 2e-4
GIN_N, GIN_DEGREE, GIN_E = 2449029, 25, 61859328


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


def gin_edges():
    """gin-tu's edges on the card, int32 (src, dst) in CSR order, padded
    with -1 to the cell's count, as ``chip_smoke.py`` builds them."""
    import torch
    from repro_torch.core.graph import uniform_random_graph
    g = uniform_random_graph(GIN_N, GIN_DEGREE, seed=0, device="cuda")
    src, dst = g.row_ids().to(torch.int32), g.indices.to(torch.int32)
    pad = torch.full((GIN_E - src.numel(),), -1, dtype=torch.int32,
                     device="cuda")
    return torch.cat([src, pad]), torch.cat([dst, pad])


def load_parent(parent: str) -> ctypes.CDLL:
    """The other checkout's segment_sum.cu, built with this checkout's
    flags."""
    from repro_torch.kernels import _build
    src = os.path.join(parent, "src", "repro_torch", "csrc", "segment_sum.cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    out = os.path.join(ROOT, "build", "pair", f"segment_sum-parent-{digest}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if not os.path.exists(out):
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # data, seg, out, n, d, m, block_n, stream
    lib.segment_sum.argtypes = [P, P, P, L, I, I, I, P]
    lib.segment_sum.restype = ctypes.c_int
    return lib


def step_walls(root: str, steps: int) -> dict:
    """The gin-tu train step of the checkout at ``root`` (this process
    imports its package): the cell's batch, one cold step, then ``steps``
    warm ones; walls on the host clock ending in a synchronize."""
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from repro_torch.configs import get_config, input_specs
    from repro_torch.configs.common import init_params, make_step
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.optim import adamw
    ac = get_config("gin-tu")
    bundle = input_specs(ac, "ogb_products")
    cfg, spec = bundle.model, bundle.batch
    (n_pad, n_feat) = spec["x"].shape
    src, dst = gin_edges()
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"x": torch.randn(n_pad, n_feat, generator=gen, device="cuda"),
             "src": src, "dst": dst,
             "labels": torch.randint(0, cfg.n_classes, (n_pad,),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32),
             "label_mask": torch.arange(n_pad, device="cuda") < GIN_N}
    state = adamw.init_state(init_params(ac, cfg, 0, device="cuda"))
    step = make_step(ac, bundle, make_rules(None), adamw.AdamWConfig(
        lr=1e-2, warmup_steps=0, total_steps=30, weight_decay=0.0))
    walls, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    return {"root": root, "cold_s": walls[0], "warm_s": walls[1:],
            "losses": losses,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--steps", type=int, default=3,
                    help="warm gin-tu steps per turn")
    ap.add_argument("--step-of", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("pair_segment_sum: needs a CUDA card", file=sys.stderr)
        return 1
    if args.step_of:
        print(json.dumps(step_walls(args.step_of, args.steps)))
        return 0
    if not args.parent:
        ap.error("--parent is required")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.graph import rmat
    from repro_torch.kernels import _build, ops
    from repro_torch.models import gnn as G

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[pair] {smi}", flush=True)
    old_lib = load_parent(args.parent)

    def old_b4(data, seg, m):
        out = torch.zeros(m, data.shape[1], device="cuda")
        _build.launch(old_lib.segment_sum, data.device, data.data_ptr(),
                      seg.data_ptr(), out.data_ptr(), data.shape[0],
                      data.shape[1], m, OLD_BLOCK_N, what="parent")
        return out

    def old_take(table, idx):
        n = table.shape[0]
        ext = torch.cat([table, table.new_zeros((1,) + tuple(
            table.shape[1:]))])
        return ext[torch.where((idx >= 0) & (idx < n), idx, n).long()]

    gen = torch.Generator(device="cuda").manual_seed(12)
    src, dst = gin_edges()
    n = GIN_N
    plan_ms = cuda_ms(lambda: [G.EdgePlan(src, dst, n, n).form(by)
                               for by in ("dst", "src")], 2)
    plan = G.EdgePlan(src, dst, n, n)
    mdst = plan.dst
    rows = []

    def turns(label, old, new, extra):
        want, got = old(), new()
        torch.cuda.synchronize()
        diff = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=PAIR_TOL, atol=PAIR_TOL):
            print(f"pair_segment_sum: {label}: the two trees disagree (max "
                  f"|new - old| {diff!r})", file=sys.stderr)
            sys.exit(1)
        del want, got
        o1 = cuda_ms(old, args.reps)
        n1 = cuda_ms(new, args.reps)
        n2 = cuda_ms(new, args.reps)
        o2 = cuda_ms(old, args.reps)
        rows.append(dict(case=label, max_abs_diff=diff, old_ms=[o1, o2],
                         new_ms=[n1, n2], speedup=(o1 + o2) / (n1 + n2),
                         **extra))
        print(f"[pair] {label}: old {o1!r} / {o2!r} ms, new {n1!r} / {n2!r} "
              f"ms (old, new, new, old), {rows[-1]['speedup']!r}x; "
              f"{extra}; max |new - old| {diff!r}", flush=True)

    for label, d, by in (("gin-tu forward, d 100", 100, "dst"),
                         ("gin-tu forward, d 64", 64, "dst"),
                         ("gin-tu backward, d 64", 64, "src")):
        table = torch.randn(n, d, device="cuda", generator=gen)
        gather_ids, seg = (src, mdst) if by == "dst" else (mdst, src)
        offsets, ids = plan.form(by)
        turns(label,
              lambda: old_b4(old_take(table, gather_ids), seg, n),
              lambda: ops.segment_sum_csr(table, offsets, ids),
              {"plan_ms_per_forward": plan_ms})
        del table
        torch.cuda.empty_cache()
    del plan, mdst, src, dst
    torch.cuda.empty_cache()

    g = rmat(20, 16, seed=7, device="cuda")
    seg = g.transpose().row_ids()
    m = g.n_rows
    del g
    data = torch.randn(seg.numel(), 64, device="cuda", generator=gen)
    # the old wrapper cast the ids to int32 inside the call
    turns("RMAT-20 in-edges, sorted ids, d 64",
          lambda: old_b4(data, seg.to(torch.int32), m),
          lambda: ops.segment_sum_sorted(data, seg, m), {})
    del data, seg
    torch.cuda.empty_cache()

    steps = []
    for root in (args.parent, ROOT, ROOT, args.parent):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--step-of", root,
             "--steps", str(args.steps)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"pair_segment_sum: the step of {root} failed:\n"
                  f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}",
                  file=sys.stderr)
            return 1
        steps.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        tree = "old" if root == args.parent else "new"
        s = steps[-1]
        print(f"[pair] gin-tu step, {tree} tree: cold {s['cold_s']!r} s, warm "
              f"{s['warm_s']} s, losses {s['losses']}, peak "
              f"{s['peak_gib']!r} GiB", flush=True)
    print(json.dumps({"device": smi, "pairs": rows, "steps": steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
