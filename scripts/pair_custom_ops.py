#!/usr/bin/env python3
"""B6's host cost in this checkout against another checkout's, in turns
on one card: old, new, new, old (written to show that B6's torch operator,
which a dry run calls on meta tensors, costs a CUDA call nothing).

    git archive <commit> | tar -x -C build/parent
    python3 scripts/pair_custom_ops.py --parent build/parent [--calls 400]

Each turn is a subprocess importing one checkout's ``repro_torch`` and
measures, on qwen3-14b's widths (bf16, 40 q / 8 kv heads of 128):

* one B6 decode call's host time: ``kernels.ops.flash_attention`` at
  batch 4 over 513 keys read in place from a 544-slot cache, ``--calls``
  calls back to back on the host clock with no synchronize (the time the
  caller waits before it can queue the next call), after a warm-up;
* a decode step: ``launch.serve.serve_lm`` at batch 4 x 512 with 32
  greedy steps on the full model drawn from seed 0, warm (the second run),
  decode seconds over the steps.

Builds each checkout's ``flash_attention.cu`` first, both at once.  Prints
the card's name and power limit, each turn's numbers, and last one JSON
line with every number.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TURN = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve_lm
from repro_torch.models import transformer as TF
calls = int(sys.argv[2])
cfg = get_config("qwen3-14b").model
B, P, G = 4, 512, 32
gen = torch.Generator(device="cuda").manual_seed(0)
q = torch.randn(B, cfg.n_heads, 1, cfg.head_dim, generator=gen,
                device="cuda", dtype=torch.bfloat16)
cache = torch.randn(2, B, cfg.n_kv_heads, P + G, cfg.head_dim,
                    generator=gen, device="cuda", dtype=torch.bfloat16)
k, v = cache[0][:, :, :P + 1], cache[1][:, :, :P + 1]
for _ in range(20):
    ops.flash_attention(q, k, v, causal=True)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(calls):
    ops.flash_attention(q, k, v, causal=True)
host_us = 1e6 * (time.perf_counter() - t0) / calls
torch.cuda.synchronize()
del q, k, v, cache
model = TF.init_params(cfg, 0).requires_grad_(False)
prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, P)).astype(
    np.int32)
serve_lm(cfg, model, prompts, G)
run = serve_lm(cfg, model, prompts, G)
print(json.dumps({"b6_decode_host_us": host_us,
                  "decode_ms_per_step": 1e3 * run["decode_s"] / G,
                  "prefill_s": run["prefill_s"]}))
"""


def build(tree: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _build; "
         "_build.compile_source('flash_attention')",
         os.path.join(tree, "src")])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="the other checkout (git archive of a commit)")
    ap.add_argument("--calls", type=int, default=400)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    trees = {"old": os.path.abspath(args.parent), "new": ROOT}
    builds = [build(t) for t in trees.values()]
    if any(b.wait() for b in builds):
        print("a build failed", file=sys.stderr)
        return 1
    turns = []
    for which in ("old", "new", "new", "old"):
        proc = subprocess.run(
            [sys.executable, "-c", TURN,
             os.path.join(trees[which], "src"), str(args.calls)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        rec = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                   tree=which)
        turns.append(rec)
        print(f"[pair] {which}: B6 decode call {rec['b6_decode_host_us']!r} "
              f"us on the host; decode {rec['decode_ms_per_step']!r} ms a "
              f"step ({smi})", flush=True)
    print(json.dumps({"nvidia_smi": smi, "calls": args.calls,
                      "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
