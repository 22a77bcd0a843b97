"""Dry run: trace every (arch x shape x mesh) cell as one rank of a
production H100 grid runs it, on the meta device (counterpart of
``repro.launch.dryrun``).

The reference compiles each cell for 512 fake XLA devices and reads the
compiled program.  The port is multi-controller and has no whole-program
graph, so the dry run runs rank 0's step once on meta tensors: the
state, the batch and the cache are meta tensors in the rank's blocks (a
GNN's batch as ``models.gnn.local_batch`` builds rank 0's block, as the
launcher hands each rank its own; an LM's tokens and FM's ids, a few MB
a rank, whole, as every rank's step takes them and slices its rows), the
mesh is a dry view of the grid
(``launch.mesh.make_production_mesh``) that counts each collective and
runs none, and the kernels B4 and B6 are their torch operators' meta
kernels.  Around the step it records:

* FLOPs (``torch.utils.flop_counter.FlopCounterMode``; B4 and B6 by
  ``kernels.cost``, B6 on the visible pairs only);
* HBM bytes: each non-view operator's tensor inputs and outputs once, B4
  and B6 by ``kernels.cost``;
* peak live bytes: every storage alive at once, from storage lifetimes,
  with the step's arguments alive from the start (what the caching
  allocator's ``max_memory_allocated`` counts, less the libraries' own
  workspaces);
* the mesh's collective inventory: calls and bytes per kind, the bytes
  this rank hands the transport;
* roofline terms against one NVIDIA H100 (``launch.mesh.HW``).

Nothing launches or builds a kernel and nothing needs a card or a CUDA
build of torch.

Usage:
  python -m repro_torch.launch.dryrun --arch gin-tu --shape molecule
  python -m repro_torch.launch.dryrun --sweep --both-meshes \\
      --out build/dryrun.json

Results are written incrementally (one record per finished cell, merged
into ``--out``), so a sweep can be watched and resumed (``--resume``
skips the cells done).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Optional

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..configs import (ARCH_NAMES, get_config, input_specs, make_step,
                       param_logical_axes, shape_names)
from ..configs.common import (LM_SHAPES, apply_variant, init_params,
                              param_shardings)
from ..distributed import fault_tolerance as FT
from ..distributed.sharding import make_rules
from ..kernels import cost
from ..kernels.segment_sum import entries_of
from ..models import gnn as GNN
from ..models import transformer as TF
from ..optim import adamw
from .mesh import HW, KINDS, make_production_mesh

__all__ = ["run_cell", "dry_step", "roofline_terms", "model_flops",
           "cell_state", "storage_bytes", "TraceCounter", "trace", "main"]

_ALLOC = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
          torch.ops.aten.new_empty.default, torch.ops.aten.empty_strided.default,
          torch.ops.aten.new_empty_strided.default}
# operators that return a view without an alias annotation
_VIEWS = {torch.ops.aten._unsafe_view.default, torch.ops.aten.lift_fresh.default}


def _kernel_bytes(func, args) -> Optional[tuple]:
    """(the kernel's name, its bytes by ``kernels.cost``) for B4's and B6's
    operators; None for another op."""
    if func is torch.ops.repro_torch.segment_sum_csr.default:
        table, offsets, rows = args[:3]
        entries = entries_of(table.shape,
                             None if rows is None else rows.shape)
        return "segment_sum", cost.segment_sum_bytes(
            entries, table.shape[1], offsets.shape[0] - 1)
    if func is torch.ops.repro_torch.flash_attention.default:
        q, k = args[:2]
        return "flash_attention", cost.attention_bytes(
            q.numel(), k.numel(), q.element_size())
    return None


def _tensors(tree) -> list:
    """The tensors of an operator's arguments or results."""
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _leaves(tree) -> list:
    """The tensors of a step's arguments: dicts, lists, tuples, dataclasses
    (a ``TrainState``) and modules (their parameters and buffers)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages of ``tree``'s tensors (a step's
    arguments, each storage once, as :func:`trace` counts them)."""
    return sum({id(t.untyped_storage()): t.untyped_storage().nbytes()
                for t in _leaves(tree)}.values())


class TraceCounter(TorchDispatchMode):
    """Counts, over the operators run under it, the HBM bytes (each
    non-view operator's tensor inputs and outputs once; allocations move
    none; B4 and B6 by ``kernels.cost``), the live bytes of every storage
    (a weakref finalizer on each storage frees its bytes) and their peak,
    and the kernels' calls by name.  ``hold(tree)`` counts tensors made
    before the trace (the step's arguments) as live from the start."""

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0
        self.live = 0
        self.peak = 0
        self.kernels = {"segment_sum": 0, "flash_attention": 0}
        self._seen: dict = {}

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._seen.pop(key, 0)

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors live; returns their
        bytes (each storage once)."""
        before = self.live
        for t in _leaves(tree):
            self._track(t)
        return self.live - before

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kernel = _kernel_bytes(func, args)
        if kernel is not None:
            self.kernels[kernel[0]] += 1
            self.hbm_bytes += kernel[1]
        elif not (func.is_view or func in _VIEWS or func in _ALLOC):
            self.hbm_bytes += sum(t.numel() * t.element_size()
                                  for t in _tensors((args, kwargs, out)))
        for t in _tensors(out):
            self._track(t)
        return out


def trace(fn, *args) -> dict:
    """Run ``fn(*args)`` once under the flop counter and a
    :class:`TraceCounter`, the tensors of ``args`` live from the start.
    Returns {'flops', 'hbm_bytes', 'argument_bytes', 'peak_bytes',
    'output_bytes', 'kernels', 'trace_s'}."""
    tc = TraceCounter()
    fc = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    argument_bytes = tc.hold(args)
    with fc, tc:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    arg_storages = {id(t.untyped_storage()) for t in _leaves(args)}
    output_bytes = sum({id(t.untyped_storage()): t.untyped_storage().nbytes()
                        for t in _leaves(out)
                        if id(t.untyped_storage()) not in arg_storages
                        }.values())
    return {"flops": float(fc.get_total_flops()),
            "hbm_bytes": float(tc.hbm_bytes),
            "argument_bytes": argument_bytes, "peak_bytes": tc.peak,
            "output_bytes": output_bytes, "kernels": dict(tc.kernels),
            "trace_s": trace_s}


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float) -> dict:
    """Per-card roofline terms in seconds (one NVIDIA H100, ``HW``)."""
    t_c = flops / HW["peak_bf16_flops"]
    t_m = hbm_bytes / HW["hbm_bw"]
    t_n = coll_bytes / HW["link_bw"]
    dom = max((t_c, "compute"), (t_m, "memory"), (t_n, "collective"))[1]
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_n,
            "dominant": dom,
            "bound_s": max(t_c, t_m, t_n),
            "roofline_fraction": (max(t_c, t_m) / max(t_c, t_m, t_n, 1e-30)
                                  if max(t_c, t_m, t_n) > 0 else 0.0)}


def model_flops(ac, bundle) -> Optional[float]:
    """MODEL_FLOPS = 6*N*D (dense LM) / 6*N_active*D (MoE) for a train step,
    2*N*D otherwise; global.  N from the whole meta ``Transformer``."""
    if ac.family != "lm":
        return None
    cfg = bundle.model
    n_total = TF.count_params(TF.init_params(cfg, device="meta"))
    if cfg.moe is not None:
        m = cfg.moe
        moe_layers = cfg.n_layers // m.period
        expert_params_per_layer = 3 * cfg.d_model * m.d_ff
        n_active = (n_total
                    - moe_layers * m.n_experts * expert_params_per_layer
                    + moe_layers * max(m.top_k, 1) * expert_params_per_layer)
    else:
        n_active = n_total
    toks = bundle.batch["tokens"].numel()
    mult = 6 if bundle.kind == "train" else 2
    return float(mult) * n_active * toks


def _decode_cache(cfg, params, bundle, rules, position: int) -> dict:
    """This rank's block of a decode cell's cache, as a meshed prefill
    gives it (a one-token prefill on meta, grown to the cell's slots),
    set at ``position``: the step writes and reads there."""
    B = bundle.batch["tokens"].shape[0]
    name, dim = ("k", 2) if "k" in bundle.cache else ("ckv", 1)
    _, cache = TF.prefill(cfg, params, torch.zeros((B, 1), dtype=torch.int32,
                                                   device="meta"), rules)
    cache = TF.grow_cache(cache, bundle.cache[name][0].shape[dim])
    cache["len"] = position
    return cache


def cell_state(ac, bundle, rules, *, seed: int = 0,
               position: Optional[int] = None) -> tuple:
    """(the step's arguments on meta tensors as rank ``rules.mesh.rank``
    holds them, the placements of its parameters).  Train: (TrainState,
    batch); prefill / serve / retrieval: (params, batch); decode: (params,
    cache, batch), the cache at ``position`` (default: its last slot).
    A meshed GNN's batch is the rank's block (``gnn.local_batch``)."""
    cfg = bundle.model
    shapes = init_params(ac, cfg, seed, device="meta")
    sh = None
    if rules.mesh is not None:
        sh = param_shardings(rules, shapes,
                             param_logical_axes(ac, cfg, shapes))
    if ac.family == "lm":
        params = init_params(ac, cfg, seed, device="meta", shardings=sh)
    else:
        params = shapes if sh is None else FT.reshard_state(shapes, sh)
    if bundle.kind == "train":
        batch = bundle.batch
        if ac.family == "gnn" and rules.mesh is not None:
            batch = GNN.local_batch(cfg, batch, rules)
        return (adamw.init_state_with_dtype(params, ac.moment_dtype),
                batch), sh
    if bundle.kind == "decode":
        if position is None:
            position = bundle.cache["k" if "k" in bundle.cache
                                    else "ckv"][0].shape[-2] - 1
        return (params, _decode_cache(cfg, params, bundle, rules, position),
                bundle.batch), sh
    return (params, bundle.batch), sh


def dry_step(ac, bundle, rules, *, position: Optional[int] = None) -> dict:
    """One step of ``bundle`` traced on meta as the rank of ``rules``'s mesh
    runs it (one card where the rules have no mesh): :func:`trace`'s
    record, with the mesh's collectives per kind, {kind: {'count',
    'bytes'}} (empty without a mesh).  ``position``: a decode step's
    (:func:`cell_state`)."""
    step = make_step(ac, bundle, rules)
    args, _ = cell_state(ac, bundle, rules, position=position)
    mesh = rules.mesh
    if mesh is not None:
        mesh.reset_counts()
    got = trace(step, *args)
    got["collectives"] = {} if mesh is None else {
        k: {"count": mesh.calls[k], "bytes": mesh.bytes[k]} for k in KINDS}
    return got


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             seq_parallel: bool = True,
             variant: Optional[str] = None) -> dict:
    """One cell's record: rank 0's step on the production grid (16 x 16
    cards, or 2 x 16 x 16 with ``multi_pod``), traced on meta."""
    # seq_parallel default on: the per-layer saved residuals are sequence-
    # sharded (Megatron SP), as the reference's dry run lays them out
    ac = get_config(arch)
    if shape in ac.skips:
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "skipped", "reason": ac.skips[shape]}
    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = make_rules(mesh, seq_parallel=seq_parallel)
    bundle = apply_variant(input_specs(ac, shape), variant)
    # a decode cell steps at its sequence's last position, where it reads
    # every slot (a sliding window's ring has wrapped)
    position = LM_SHAPES[shape]["seq"] - 1 if bundle.kind == "decode" \
        else None
    got = dry_step(ac, bundle, rules, position=position)
    trace_s = time.perf_counter() - t0
    coll = got["collectives"]
    coll_bytes = sum(c["bytes"] for c in coll.values())
    roof = roofline_terms(got["flops"], got["hbm_bytes"], coll_bytes)
    mf = model_flops(ac, bundle)
    n_chips = mesh.size
    mem = {"argument_size_in_bytes": got["argument_bytes"],
           "temp_size_in_bytes": got["peak_bytes"] - got["argument_bytes"],
           "output_size_in_bytes": got["output_bytes"]}
    return {
        "arch": arch, "shape": shape, "multi_pod": multi_pod,
        "variant": variant, "status": "ok", "kind": bundle.kind,
        "n_chips": n_chips, "rank": mesh.rank,
        "view": f"rank {mesh.rank} of {n_chips}, grid {mesh.shape} over "
                f"{mesh.axis_names}",
        "trace_s": round(trace_s, 1),
        "per_device": {
            "flops": got["flops"], "hbm_bytes": got["hbm_bytes"],
            "collective_bytes": coll_bytes,
            "memory": mem, "total_hbm_used": got["peak_bytes"],
            "fits_80gb": bool(got["peak_bytes"] < HW["hbm_per_chip"]),
            "kernel_calls": got["kernels"],
        },
        "collectives": coll,
        "roofline": roof,
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / (got["flops"] * n_chips)
                               if (mf and got["flops"] > 0) else None),
    }


# the sweep's order: smallest families first, so results accumulate early
_ORDER = {"gin-tu": 0, "gatedgcn": 1, "fm": 2, "dimenet": 3,
          "equiformer-v2": 4, "mixtral-8x7b": 5, "qwen3-14b": 6,
          "minicpm3-4b": 7, "llama4-maverick-400b-a17b": 8,
          "mistral-large-123b": 9}


def _line(rec: dict) -> str:
    r = rec.get("roofline", {})
    head = (f"[{rec['arch']} x {rec['shape']} "
            f"pods={1 + int(rec['multi_pod'])}] {rec['status']} ")
    if rec["status"] != "ok":
        return head + rec.get("reason", rec.get("error", ""))
    return head + (f"trace={rec.get('trace_s')}s dom={r.get('dominant')} "
                   f"fit={rec['per_device']['fits_80gb']} "
                   f"cT={r.get('compute_s', 0):.2e} "
                   f"mT={r.get('memory_s', 0):.2e} "
                   f"nT={r.get('collective_s', 0):.2e}")


def main(argv: Optional[list] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--seq-parallel", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="named model transform (configs.common.VARIANTS)")
    args = ap.parse_args(argv)

    results: list = []
    if args.out and args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["multi_pod"]) for r in results}

    def emit(rec: Any) -> None:
        results.append(rec)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
        print(_line(rec), flush=True)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.sweep:
        cells = [(a, s, mp) for a in ARCH_NAMES
                 for s in shape_names(get_config(a)) for mp in meshes]
        cells.sort(key=lambda c: (_ORDER.get(c[0], 99), c[1], c[2]))
        for a, s, mp in cells:
            if (a, s, mp) in done:
                continue
            try:
                emit(run_cell(a, s, multi_pod=mp,
                              seq_parallel=args.seq_parallel,
                              variant=args.variant))
            except Exception as e:  # noqa: BLE001 — record, go on
                emit({"arch": a, "shape": s, "multi_pod": mp,
                      "status": "error", "error": f"{type(e).__name__}: {e}",
                      "trace": traceback.format_exc()[-2000:]})
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --sweep)")
        for mp in meshes:
            emit(run_cell(args.arch, args.shape, multi_pod=mp,
                          seq_parallel=args.seq_parallel,
                          variant=args.variant))
    return results


if __name__ == "__main__":
    main()
