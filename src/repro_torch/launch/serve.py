"""Batched serving (counterpart of ``repro.launch.serve``): prefill
then greedy decode with a shared KV cache, or FM scoring of a recsys
batch, on the card unless ``--device`` says otherwise.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
      --batch 4 --prompt-len 512 --gen 32

Parameters are drawn from ``--seed`` by a ``torch.Generator`` on the
device.  :func:`serve_lm` and :func:`score_fm` take the parameters, so a
caller can serve weights of its own.  Prints the prefill seconds, decode
tokens per second and the peak device memory.

Several processes (``WORLD_SIZE`` > 1, as ``torch.distributed.run`` sets
it) serve an LM over a ``("data", "model")`` mesh of ``--grid D,M`` ranks
(default (1, world): tensor parallel, no FSDP gather a step): each rank
draws its blocks of the weights, every rank runs every step on the whole
prompts, and rank 0 prints:

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.serve --arch qwen3-14b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs import get_config
from ..configs.common import param_logical_axes, param_shardings
from ..core.graph import resolve_device
from ..distributed.sharding import make_rules
from ..models import recsys as RS
from ..models import transformer as TF
from ..data import synthetic
from .mesh import backend_for, init_world, make_mesh

__all__ = ["serve_lm", "score_fm", "cache_len_for", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cache_len_for(cfg: TF.LMConfig, prompt_len: int, gen: int) -> int:
    """The decode cache's slots: prompt + generated tokens, cut to the
    window for a sliding-window model (a ring).  A prompt longer than that
    keeps its prefilled length."""
    max_len = prompt_len + gen
    if cfg.window is not None:
        max_len = min(max_len, max(cfg.window, 1))
    return max(max_len, prompt_len)


@torch.inference_mode()
def serve_lm(cfg: TF.LMConfig, model: TF.Transformer, prompts,
             gen: int, *, keep_logits: bool = False, rules=None) -> dict:
    """Prefill ``prompts`` (B, P) and decode ``gen`` tokens greedily.
    Returns the generated ids (B, gen) as numpy, the last logits, and the
    host seconds of prefill and decode (each ending in a synchronize);
    with ``keep_logits`` also the prefill's logits and each decode step's,
    stacked (gen, B, vocab).  Over a mesh (``rules``) every rank calls
    with the whole prompts and its blocks of the weights, and every rank
    gets the whole logits, so all pick the same ids."""
    rules = rules or make_rules(None)
    dev = model.device
    prompts = torch.as_tensor(np.asarray(prompts), device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = TF.prefill(cfg, model, prompts, rules)
    cache = TF.grow_cache(cache, cache_len_for(cfg, prompts.shape[1], gen))
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    kept = {"prefill_logits": logits} if keep_logits else {}
    out, steps = [], []
    tok = logits.argmax(-1)[:, None]
    t0 = time.perf_counter()
    for _ in range(gen):
        out.append(tok[:, 0])
        logits, cache = TF.decode_step(cfg, model, cache, tok, rules)
        tok = logits.argmax(-1)[:, None]
        if keep_logits:
            steps.append(logits)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    ids = torch.stack(out, 1).cpu().numpy() if out else \
        np.zeros((prompts.shape[0], 0), np.int64)
    if steps:
        kept["step_logits"] = torch.stack(steps)
    return {"tokens": ids, "logits": logits, "prefill_s": prefill_s,
            "decode_s": decode_s,
            "tok_per_s": prompts.shape[0] * gen / max(decode_s, 1e-9),
            **kept}


@torch.inference_mode()
def score_fm(cfg: RS.FMConfig, params: dict, ids) -> dict:
    """FM scores of ids (B, F), with the host seconds (ending in a
    synchronize)."""
    dev = params["table"].device
    ids = torch.as_tensor(np.asarray(ids), device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    s = RS.fm_scores(cfg, params, ids, make_rules(None))
    _sync(dev)
    return {"scores": s, "seconds": time.perf_counter() - t0}


def _peak(device: torch.device) -> str:
    if device.type != "cuda":
        return "peak device memory not measured (not a card)"
    return (f"peak device memory "
            f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")


def main(argv: Optional[list] = None) -> dict:
    """The CLI; returns the numbers it prints (rank 0's over a mesh, None
    on the other ranks)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", default=None,
                    help="D,M: the ('data', 'model') grid of a process "
                         "world (default: 1,world)")
    args = ap.parse_args(argv)

    ac = get_config(args.arch)
    cfg = ac.smoke if args.smoke else ac.model
    dev = resolve_device(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 or args.grid is not None:
        if ac.family != "lm" or world < 2:
            raise ValueError("--grid and a process world serve an LM")
        init_world(backend_for(dev, world), init_method="env://",
                   world_size=world, rank=int(os.environ["RANK"]))
        try:
            grid = ((1, world) if args.grid is None else
                    tuple(int(n) for n in args.grid.split(",")))
            return _serve_meshed(args, cfg, make_mesh(grid, ("data", "model"),
                                                      device=dev))
        finally:
            dist.destroy_process_group()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    if ac.family == "recsys":
        params = RS.init_params(cfg, args.seed, device=dev)
        b = next(synthetic.recsys_batches(args.batch, cfg.n_fields,
                                          cfg.rows_per_field, seed=args.seed))
        r = score_fm(cfg, params, b["ids"])
        mean = float(r["scores"].mean())
        print(f"scored {args.batch} requests in {r['seconds']:.3f}s; "
              f"mean score {mean:.4f}; {_peak(dev)}")
        return {"seconds": r["seconds"], "mean_score": mean,
                "peak": _peak(dev)}

    model = TF.init_params(cfg, args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)
                           ).astype(np.int32)
    r = serve_lm(cfg, model, prompts, args.gen)
    print(f"prefill {args.batch}x{args.prompt_len} in {r['prefill_s']:.3f}s; "
          f"decoded {args.gen} tokens in {r['decode_s']:.3f}s "
          f"({r['tok_per_s']:.1f} tok/s); {_peak(dev)}")
    print("sample generation ids:", r["tokens"][0][:12].tolist())
    return _numbers(r, dev)


def _numbers(r: dict, dev: torch.device) -> dict:
    return {"prefill_s": r["prefill_s"], "decode_s": r["decode_s"],
            "tok_per_s": r["tok_per_s"], "tokens": r["tokens"],
            "peak": _peak(dev)}


def _serve_meshed(args, cfg, mesh) -> Optional[dict]:
    """The LM served over ``mesh``: this rank's blocks drawn from the seed,
    every rank stepping, rank 0 printing."""
    rules = make_rules(mesh)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    shapes = TF.init_params(cfg, args.seed, device="meta")
    sh = param_shardings(rules, shapes, param_logical_axes(
        get_config(args.arch), cfg, shapes))
    model = TF.init_params(cfg, args.seed, device=dev, shardings=sh)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)
                           ).astype(np.int32)
    r = serve_lm(cfg, model, prompts, args.gen, rules=rules)
    if mesh.rank == 0:
        print(f"grid {mesh.shape}: prefill {args.batch}x{args.prompt_len} "
              f"in {r['prefill_s']:.3f}s; decoded {args.gen} tokens in "
              f"{r['decode_s']:.3f}s ({r['tok_per_s']:.1f} tok/s); "
              f"{mesh.collectives} collectives; rank 0's {_peak(dev)}")
        print("sample generation ids:", r["tokens"][0][:12].tolist())
        return {**_numbers(r, dev), "collectives": mesh.collectives}
    return None


if __name__ == "__main__":
    main()
