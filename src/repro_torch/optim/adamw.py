"""AdamW with cosine schedule, global-norm clipping, optional bf16 moments
(counterpart of ``repro.optim.adamw``).

The arithmetic is the reference's: moments updated in float32 and cast
back to their dtype, the parameter updated in float32 and cast back to
its own; weight decay on every parameter, norms included; the clipping
norm taken over every gradient in float32; bias correction from the
incremented step.

Parameters are an ``nn.Module`` (the transformer) or a nested dict / list
of tensors (GNN, FM).  :func:`named_params` names them: a module by
``named_parameters`` ("layers.0.attn.wq"), a tree by its path joined with
"/" ("layer0/mlp/0/w").  The moments are flat dicts under those names;
``step`` is a 0-d int32 tensor on the parameters' device, so a step reads
nothing back to the host.  :func:`apply_update` updates everything in
place from each parameter's ``.grad``.

Over a process mesh each rank updates its block of every parameter from
its block of the gradient (``configs.make_step`` has summed the
replicated parameters' gradients over the ranks).  The clipping norm is
the whole gradient's: the squares of a sharded parameter's blocks are
summed over the ranks that split it, a replicated parameter counts once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch import nn

__all__ = ["AdamWConfig", "TrainState", "named_params", "init_state",
           "init_state_with_dtype", "apply_update", "cosine_schedule",
           "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: torch.dtype = torch.float32   # bf16 for the 400B MoE config


@dataclasses.dataclass
class TrainState:
    params: Any                       # nn.Module, or a dict / list tree
    m: Dict[str, torch.Tensor]        # first moments by parameter name
    v: Dict[str, torch.Tensor]        # second moments by parameter name
    step: torch.Tensor                # 0-d int32, on the parameters' device


def named_params(params) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a module's parameters or a tree's tensor leaves,
    in the module's order or the tree's (dict keys sorted, as the
    reference's pytrees flatten)."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, x in enumerate(node):
                walk(x, path + (str(i),))
        else:
            out["/".join(path)] = node
    walk(params, ())
    return out


def _device(params) -> torch.device:
    return next(iter(named_params(params).values())).device


def init_state_with_dtype(params, moment_dtype) -> TrainState:
    """Zero moments in ``moment_dtype``, step 0.  The floating parameters
    of a tree are made to require grad (a module's already do)."""
    named = named_params(params)
    for p in named.values():
        if p.is_floating_point() and not p.requires_grad:
            p.requires_grad_(True)
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                  device=p.device)
    return TrainState(params=params,
                      m={k: zeros(p) for k, p in named.items()},
                      v={k: zeros(p) for k, p in named.items()},
                      step=torch.zeros((), dtype=torch.int32,
                                       device=_device(params)))


def init_state(params) -> TrainState:
    return init_state_with_dtype(params, torch.float32)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tensors, shardings: Optional[dict] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32.  Over a
    mesh ``tensors`` is a dict of this rank's blocks and ``shardings``
    their ``Placement`` by name (None: replicated): each sharded block's
    squares are summed over the ranks that split it (one all-reduce per
    set of mesh axes), so every rank gets the whole tensors' norm."""
    if shardings is None:
        tensors = list(tensors.values() if isinstance(tensors, dict)
                       else tensors)
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for x in tensors))
    total, split = None, {}
    for k, x in tensors.items():
        sq = torch.sum(torch.square(x.to(torch.float32)))
        pl = shardings.get(k)
        if pl is None or pl.replicated:
            total = sq if total is None else total + sq
        else:
            key = (id(pl.mesh), pl.axes)
            split.setdefault(key, [pl.mesh.over(pl.axes), []])[1].append(sq)
    for mesh, parts in split.values():
        sq = mesh.all_reduce(torch.stack(parts).sum().reshape(1), "sum")[0]
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_update(cfg: AdamWConfig, state: TrainState,
                 shardings: Optional[dict] = None) -> TrainState:
    """One AdamW step from each parameter's ``.grad``, in place:
    parameters, moments and ``step``.  A parameter that requires grad and
    has no gradient raises (the backward lost it: no silent skip).
    ``shardings``: over a mesh, each parameter's ``Placement`` by name,
    for the clipping norm (:func:`global_norm`).  Returns ``state``."""
    named = named_params(state.params)
    missing = [k for k, p in named.items()
               if p.requires_grad and p.grad is None]
    if missing:
        raise RuntimeError(
            f"apply_update: {len(missing)} parameter(s) require grad but "
            f"have no gradient, e.g. {missing[:3]}: the backward pass did "
            f"not reach them")
    grads = {k: p.grad for k, p in named.items() if p.requires_grad}
    state.step.add_(1)
    step = state.step
    lr = cosine_schedule(cfg, step)
    gn = global_norm(grads, shardings)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
             if cfg.clip_norm else 1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    for k, g in grads.items():
        p, m, v = named[k], state.m[k], state.v[k]
        g = g.to(torch.float32) * scale
        m_new = b1 * m.to(torch.float32) + (1 - b1) * g
        v_new = b2 * v.to(torch.float32) + (1 - b2) * g * g
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps) \
            + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    return state
