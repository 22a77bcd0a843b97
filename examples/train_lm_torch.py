"""End-to-end LM training on the torch port: a ~100M-parameter qwen3-family
model trained on synthetic token streams, with checkpointing and the
fault-tolerant loop (``repro_torch.distributed.fault_tolerance``).  Runs on
the card unless given ``--device cpu``.

Full run (~100M params):
  PYTHONPATH=src python examples/train_lm_torch.py --d-model 640 \\
      --layers 10 --steps 300

Demo size (~25M params; same code path):
  PYTHONPATH=src python examples/train_lm_torch.py --demo

A run resumes from the newest checkpoint in ``--ckpt-dir``: give a fresh
directory for a fresh run.  ``main(argv)`` returns the numbers it prints.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager, latest_step
from repro_torch.configs import get_config
from repro_torch.configs.common import SpecBundle, make_step
from repro_torch.data.synthetic import lm_batches, prefetch
from repro_torch.distributed.fault_tolerance import FTConfig, run_training
from repro_torch.distributed.sharding import make_rules
from repro_torch.models.transformer import LMConfig, count_params, init_params
from repro_torch.optim import adamw


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-model", type=int, default=640)
    ap.add_argument("--layers", type=int, default=10)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--demo", action="store_true", help="demo size (~25M)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--metrics-out", default=None)
    args = ap.parse_args(argv)

    if args.demo:
        args.d_model, args.layers, args.vocab = 384, 6, 16000

    dev = torch.device(args.device)
    cfg = LMConfig(
        name="train-lm-example", n_layers=args.layers, d_model=args.d_model,
        n_heads=args.d_model // 64, n_kv_heads=max(args.d_model // 128, 1),
        head_dim=64, d_ff=4 * args.d_model, vocab=args.vocab, qk_norm=True,
        dtype=torch.float32, k_chunk=128)
    model = init_params(cfg, 0, device=dev)
    n_params = count_params(model)
    print(f"model: {n_params / 1e6:.1f}M params "
          f"({cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab})")

    opt = adamw.AdamWConfig(lr=args.lr,
                            warmup_steps=max(args.steps // 20, 10),
                            total_steps=args.steps, weight_decay=0.1)
    ac = get_config("qwen3-14b")   # same family; the step needs its kind
    step = make_step(ac, SpecBundle("train", cfg, {}, {}), make_rules(None),
                     opt)
    state = adamw.init_state(model)
    batches = ({"tokens": torch.as_tensor(b["tokens"], device=dev)}
               for b in prefetch(lm_batches(args.batch, args.seq, cfg.vocab)))
    ckpt = CheckpointManager(args.ckpt_dir, every=100, keep=2)
    logs = []

    def on_metrics(i, m):
        if i == 1 or i % 10 == 0 or i == args.steps:
            rec = {"step": i, "loss": float(m["loss"])}
            logs.append(rec)
            print(json.dumps(rec), flush=True)

    t0 = time.time()
    state, report = run_training(step, state, batches, ckpt, args.steps,
                                 FTConfig(ckpt_every=100),
                                 on_metrics=on_metrics)
    dt = time.time() - t0
    steps_run = report["steps_run"]
    if logs:
        print(f"trained {steps_run} steps in {dt / 60:.1f} min "
              f"({dt / max(steps_run, 1):.2f}s/step); "
              f"loss {logs[0]['loss']:.3f} -> {logs[-1]['loss']:.3f}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(logs, f)
    return {"n_params": n_params, "steps_run": steps_run,
            "seconds": dt, "losses": logs, "restarts": report["restarts"],
            "checkpoint_step": latest_step(args.ckpt_dir)}


if __name__ == "__main__":
    main()
