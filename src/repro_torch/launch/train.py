"""End-to-end training driver (counterpart of ``repro.launch.train``), on
the card unless ``--device`` says otherwise.

Composes the config registry -> synthetic data pipeline -> the train step
(``configs.make_step``: loss forward and backward, AdamW in place) -> the
fault-tolerant loop (periodic async checkpoints, restart-on-failure,
straggler log) -> per-step JSON metric records and a ``done:`` line.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gin-tu --smoke \
      --steps 3 [--device cpu] [--ckpt-dir DIR]

A run resumes from the newest checkpoint in ``--ckpt-dir`` (default
``build/train_ckpt`` under the repository root); give a fresh directory
for a fresh run.

Several processes (``WORLD_SIZE`` > 1, as ``torch.distributed.run`` sets
it, or a process group already initialized) train one model over a
``("data", "model")`` mesh of ``--grid D,M`` ranks (default (world, 1)),
as the reference meshes its devices; every rank draws the same global
batches and the models take its block of each (a GNN rank builds only
its block of the edge and triplet arrays: ``gnn.local_batch``; the graph,
the node arrays and ``pos`` stay whole).  An LM's parameters are
drawn as its blocks (FSDP over ``data``, tensor / expert parallel over
``model``).  Rank 0 prints and writes the checkpoints:

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.train --arch qwen3-14b --smoke --steps 3 \
      --grid 2,2 --device cpu --ckpt-dir build/ck4
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..checkpoint.ckpt import CheckpointManager
from ..configs import get_config
from ..configs.common import (SpecBundle, init_params, make_step,
                              param_logical_axes, param_shardings,
                              state_shardings)
from ..core.graph import resolve_device, uniform_random_graph
from ..data import synthetic
from ..distributed.fault_tolerance import (FTConfig, reshard_state,
                                           run_training)
from ..distributed.sharding import make_rules
from ..models import gnn as GNN
from ..optim import adamw
from .mesh import backend_for, init_world, make_mesh

__all__ = ["build_batch_iter", "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _tensors(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def build_batch_iter(ac, model_cfg, args, rules=None):
    """Host batches (CPU tensors, prefetched on a thread); the models move
    them to their device.  lm: Zipf token streams; recsys: click batches;
    gnn: a fresh labelled batch over one random graph every step, over a
    mesh (``rules``) this rank's block of it (a ``gnn.RankBatch``: the
    Wigner blocks and triplets built for the rank's rows alone)."""
    meshed = rules is not None and rules.mesh is not None
    if ac.family == "lm":
        it = synthetic.lm_batches(args.batch, args.seq, model_cfg.vocab,
                                  seed=args.seed)
        return (_tensors(b) for b in synthetic.prefetch(it))
    if ac.family == "recsys":
        it = synthetic.recsys_batches(args.batch, model_cfg.n_fields,
                                      model_cfg.rows_per_field, seed=args.seed)
        return (_tensors(b) for b in synthetic.prefetch(it))

    def gen():
        g = uniform_random_graph(args.gnn_nodes, 4, seed=args.seed,
                                 device="cpu")
        i = 0
        while True:
            if not meshed:
                yield _tensors(synthetic.gnn_batch(
                    model_cfg.arch, g, model_cfg.d_feat, model_cfg.n_classes,
                    l_max=model_cfg.l_max, seed=args.seed + i))
            else:
                b = synthetic.gnn_inputs(model_cfg.arch, g, model_cfg.d_feat,
                                         model_cfg.n_classes,
                                         seed=args.seed + i)
                if model_cfg.arch == "dimenet":
                    b.update(synthetic.triplet_rows(
                        b["src"], b["dst"], b["pos"]).entries())
                if model_cfg.arch == "equiformer_v2":
                    b.update(synthetic.wigner_rows(
                        b["src"], b["dst"], b["pos"],
                        model_cfg.l_max).entries())
                yield GNN.local_batch(model_cfg, b, rules)
            i += 1
    return synthetic.prefetch(gen())


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--gnn-nodes", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(_ROOT, "build", "train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--grid", default=None,
                    help="D,M: the ('data', 'model') grid of a process "
                         "world (default: world,1)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    ac = get_config(args.arch)
    model_cfg = ac.smoke if args.smoke else ac.model
    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh, own_group = None, False
    if world > 1 and not dist.is_initialized():
        init_world(backend_for(dev, world), init_method="env://",
                   world_size=world, rank=int(os.environ["RANK"]))
        own_group = True
    if dist.is_initialized():
        grid = ((dist.get_world_size(), 1) if args.grid is None else
                tuple(int(n) for n in args.grid.split(",")))
        mesh = make_mesh(grid, ("data", "model"), device=dev)
        dev = mesh.device
    elif args.grid is not None:
        raise ValueError("--grid needs a process world (WORLD_SIZE > 1)")
    try:
        return _train(args, ac, model_cfg, mesh, dev)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, ac, model_cfg, mesh, dev) -> dict:
    rules = make_rules(mesh)
    lead = mesh is None or mesh.rank == 0
    bundle = SpecBundle("train", model_cfg, {}, {})
    opt = adamw.AdamWConfig(lr=args.lr,
                            warmup_steps=min(100, args.steps // 10 + 1),
                            total_steps=args.steps,
                            moment_dtype=ac.moment_dtype)
    step = make_step(ac, bundle, rules, opt)

    shapes = init_params(ac, model_cfg, args.seed, device="meta")
    n_params = sum(p.numel() for p in adamw.named_params(shapes).values())
    shardings = param_shardings(rules, shapes,
                                param_logical_axes(ac, model_cfg, shapes))
    if mesh is not None and ac.family == "lm":
        params = init_params(ac, model_cfg, args.seed, device=dev,
                             shardings=shardings)
    else:
        params = init_params(ac, model_cfg, args.seed, device=dev)
        if mesh is not None:
            params = reshard_state(params, shardings)
    state = adamw.init_state_with_dtype(params, ac.moment_dtype)
    if lead:
        print(f"arch={args.arch} params={n_params / 1e6:.1f}M "
              f"devices={1 if mesh is None else mesh.size} ({dev})")

    batches = build_batch_iter(ac, model_cfg, args, rules)
    ckpt = CheckpointManager(args.ckpt_dir, every=args.ckpt_every, keep=3)
    logs = []

    def on_metrics(i, m):
        if i % args.log_every == 0 or i == args.steps:
            rec = {"step": i, **{k: float(v) for k, v in m.items()}}
            logs.append(rec)
            if lead:
                print(json.dumps(rec), flush=True)

    t0 = time.time()
    state, report = run_training(
        step, state, batches, ckpt, args.steps,
        FTConfig(ckpt_every=args.ckpt_every), on_metrics=on_metrics,
        shardings=None if mesh is None else state_shardings(shardings))
    dt = time.time() - t0
    if lead:
        print(f"done: {report['steps_run']} steps in {dt:.1f}s "
              f"({dt / max(report['steps_run'], 1):.3f}s/step), "
              f"restarts={report['restarts']}, "
              f"stragglers={len(report['straggler_events'])}")
    summary = {"logs": logs,
               "report": {k: v for k, v in report.items()
                          if k != "straggler_events"}}
    if args.metrics_out and lead:
        with open(args.metrics_out, "w") as f:
            json.dump(summary, f)
    return summary


if __name__ == "__main__":
    main()
