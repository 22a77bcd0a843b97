"""Factorization Machine (Rendle, ICDM'10) over the PIUMA embedding engine
(counterpart of ``repro.models.recsys``): scoring, its loss and, under
autograd, its gradients.

score(x) = w0 + sum_i w_i x_i + 1/2 [ (sum_i v_i x_i)^2 - sum_i (v_i x_i)^2 ]

The linear weight and the latent vector are fused into one (V, 1 + k)
table, so one gather of a (sample, field) row serves both.  Each sample
takes one id per field, so the lookup is a gather
(``core.offload.dma_gather``), as in the reference, not a bag.

Batch schemas:
  train/serve:   {"ids": (B, F) int global row ids, "labels": (B,) f32}
  retrieval:     {"ids": (1, F) user fields, "cand": (Ncand, k) item vectors,
                  "cand_bias": (Ncand,)}
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import offload
from ..core.graph import resolve_device
from ..distributed.sharding import MeshRules, make_rules

__all__ = ["FMConfig", "init_params", "fm_scores", "loss_fn",
           "retrieval_scores"]


@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str
    n_fields: int = 39
    embed_dim: int = 10
    rows_per_field: int = 1_000_000
    # the reference's DGAS table exchange when a mesh is active; needs mesh
    # rules, which wait for slice 14
    use_dgas: bool = False
    dgas_cap_factor: int = 4
    dtype: torch.dtype = torch.float32

    @property
    def n_rows(self) -> int:
        return self.n_fields * self.rows_per_field

    @property
    def n_rows_padded(self) -> int:
        """Table padded to a mesh multiple (row-sharded DGAS block rule)."""
        return -(-self.n_rows // 512) * 512


def init_params(cfg: FMConfig, seed: int = 0, *, device=None) -> dict:
    """{"table": (n_rows_padded, 1 + k) N(0, 0.01^2), "w0": 0}, drawn by a
    ``torch.Generator`` on ``device`` (CUDA unless it says otherwise)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((cfg.n_rows_padded, 1 + cfg.embed_dim),
                        generator=gen, dtype=torch.float32, device=dev)
    return {"table": table.mul_(0.01).to(cfg.dtype),
            "w0": torch.zeros((), dtype=torch.float32, device=dev)}


def _fm_from_rows(w0, rows):
    lin = rows[..., 0].sum(-1)
    v = rows[..., 1:].float()                                   # (..., F, k)
    s = v.sum(dim=-2)                                           # sum-square trick
    inter = 0.5 * ((s * s).sum(-1) - (v * v).sum(dim=(-2, -1)))
    return w0 + lin.float() + inter


def _ids(params, ids) -> torch.Tensor:
    return torch.as_tensor(ids, device=params["table"].device)


def fm_scores(cfg: FMConfig, params, ids,
              rules: Optional[MeshRules] = None) -> torch.Tensor:
    """ids (B, F) -> (B,) scores. One fused gather per (sample, field)."""
    rules = rules or make_rules(None)
    if cfg.use_dgas and rules.mesh is not None:
        raise NotImplementedError("the DGAS lookup needs mesh rules "
                                  "(ROADMAP §A.9, slice 14)")
    rows = offload.dma_gather(params["table"], _ids(params, ids))  # (B, F, 1+k)
    rows = rules.constrain(rows, "batch", None, None)
    return _fm_from_rows(params["w0"], rows)


def loss_fn(cfg: FMConfig, params, batch, rules: Optional[MeshRules] = None):
    scores = fm_scores(cfg, params, batch["ids"], rules)
    y = torch.as_tensor(batch["labels"], device=scores.device).float()
    loss = torch.mean(torch.clamp(scores, min=0) - scores * y
                      + torch.log1p(torch.exp(-scores.abs())))  # stable BCE
    acc = torch.mean(((scores > 0) == (y > 0.5)).float())
    return loss, {"loss": loss, "acc": acc}


def retrieval_scores(cfg: FMConfig, params, ids, cand, cand_bias,
                     rules: Optional[MeshRules] = None) -> torch.Tensor:
    """Score ONE query against Ncand candidates as a single batched dot:
    score(u, c) = const(u) + bias_c + <sum_f v_f(u), v_c>."""
    rules = rules or make_rules(None)
    rows = offload.dma_gather(params["table"], _ids(params, ids))  # (1, F, 1+k)
    v = rows[..., 1:].float()[0]                                # (F, k)
    u_vec = v.sum(0)                                            # (k,)
    u_const = (params["w0"] + rows[..., 0].sum()
               + 0.5 * ((u_vec ** 2).sum() - (v * v).sum()))
    cand = rules.constrain(cand, "rows", None)
    return u_const + cand_bias.float() + cand.float() @ u_vec
