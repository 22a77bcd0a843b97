"""Factorization Machine (Rendle, ICDM'10) over the PIUMA embedding engine
(counterpart of ``repro.models.recsys``): scoring, its loss and, under
autograd, its gradients.

score(x) = w0 + sum_i w_i x_i + 1/2 [ (sum_i v_i x_i)^2 - sum_i (v_i x_i)^2 ]

The linear weight and the latent vector are fused into one (V, 1 + k)
table, so one gather of a (sample, field) row serves both.  Each sample
takes one id per field, so the lookup is a gather
(``core.offload.dma_gather``), as in the reference, not a bag.

Over a process mesh (``rules`` from ``make_rules(mesh)``) the table is
row-sharded over the flat axes (its ``("rows", None)`` axes; whole where
the flat size does not divide it) and ``w0`` is whole.  The functions take
the *global* batch, the same on every rank, and each rank scores its rows
of it (:func:`score_rows` says which).  With ``use_dgas`` each rank takes
its block of the batch along the flat axes, as the reference's
``shard_map`` does, and routes each (sample, field) request to the row's
owner: only the requested rows cross between ranks, and the backward
sums the gradient's rows at the owner (torch's ``index_add_``: FM calls
no TPU kernel).  Otherwise, or where the flat size divides neither the
batch nor the table, each rank gathers its block of the batch along the
data axes from the all-gathered table, the reference's GSPMD gather.

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
from ..core.dgas import block_rule
from ..core.graph import resolve_device
from ..distributed import routed
from ..distributed.sharding import MeshRules, Placement, make_rules

__all__ = ["FMConfig", "init_params", "fm_scores", "loss_fn",
           "retrieval_scores", "score_rows"]


@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str
    n_fields: int = 39
    embed_dim: int = 10
    rows_per_field: int = 1_000_000
    # PIUMA fine-grained table access: when True (and a mesh is active)
    # the lookup routes each request to the owner of the row-sharded
    # table's row instead of gathering from the all-gathered table;
    # backward of the routed gather is the routed scatter-add at the owner
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
    ``torch.Generator`` on ``device`` (CUDA unless it says otherwise; the
    ``meta`` device for the shapes alone)."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
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


def _uses_dgas(cfg: FMConfig, rules: MeshRules, B: int) -> bool:
    """The reference's rule: DGAS when asked for over a mesh, unless the
    flat size divides neither the global batch B nor the table."""
    S = rules._axis_size(rules.flat)
    return (cfg.use_dgas and rules.mesh is not None and B % S == 0
            and cfg.n_rows_padded % S == 0)


def score_rows(cfg: FMConfig, rules: MeshRules, B: int) -> Optional[Placement]:
    """The placement of the rows of a global batch of B rows that this
    rank scores (None without a mesh: all of them): its block along the
    flat axes on the DGAS path, along the data axes otherwise."""
    if rules.mesh is None:
        return None
    if _uses_dgas(cfg, rules, B):
        return Placement((rules.flat,), rules.mesh)
    return rules.input_sharding((B,), "batch")


def _whole_table(cfg: FMConfig, params, rules: MeshRules) -> torch.Tensor:
    """The whole table over a mesh: all-gathered when it is row-sharded
    (its gradient reduced back to each rank's block)."""
    table = params["table"]
    mesh = rules.mesh.over(rules.flat)
    if cfg.n_rows_padded % mesh.size:
        return table
    return routed.all_gather_rows(table, mesh)


def fm_scores(cfg: FMConfig, params, ids,
              rules: Optional[MeshRules] = None) -> torch.Tensor:
    """ids (B, F) -> (B,) scores. One fused gather per (sample, field).
    Over a mesh: the scores of this rank's rows (:func:`score_rows`)."""
    rules = rules or make_rules(None)
    ids = _ids(params, ids)
    if rules.mesh is None:
        rows = offload.dma_gather(params["table"], ids)         # (B, F, 1+k)
        rows = rules.constrain(rows, "batch", None, None)
        return _fm_from_rows(params["w0"], rows)
    B = ids.shape[0]
    ids = score_rows(cfg, rules, B).block(ids)
    if not _uses_dgas(cfg, rules, B):
        rows = offload.dma_gather(_whole_table(cfg, params, rules), ids)
        return _fm_from_rows(params["w0"], rows)
    # the DGAS lookup: requests route to the owning table shard, and only
    # the requested (1 + k)-float rows return, never a table replica
    mesh = rules.mesh.over(rules.flat)
    S = mesh.size
    local_req = ids.numel()
    cap = int(min(local_req, cfg.dgas_cap_factor * (-(-local_req // S))))
    table = params["table"]
    flat = routed.gather(table, ids.reshape(-1),
                         block_rule(cfg.n_rows_padded, S), mesh,
                         capacity=cap, b4=False)
    return _fm_from_rows(params["w0"],
                         flat.reshape(ids.shape + (table.shape[-1],)))


def loss_fn(cfg: FMConfig, params, batch, rules: Optional[MeshRules] = None):
    """(loss, metrics).  Over a mesh both are the global ones, on every
    rank; the loss carries the gradient of this rank's share (its rows'
    sum over the count of every rank's rows)."""
    rules = rules or make_rules(None)
    scores = fm_scores(cfg, params, batch["ids"], rules)
    y = torch.as_tensor(batch["labels"], device=scores.device).float()
    if rules.mesh is not None:
        y = score_rows(cfg, rules, y.shape[0]).block(y)
    bce = (torch.clamp(scores, min=0) - scores * y
           + torch.log1p(torch.exp(-scores.abs())))             # stable BCE
    hit = ((scores > 0) == (y > 0.5)).float()
    if rules.mesh is None:
        loss = bce.mean()
        return loss, {"loss": loss, "acc": hit.mean()}
    loss, acc = routed.global_mean(bce.sum(), hit.sum(), bce.numel(),
                                   rules.mesh.over(rules.flat))
    return loss, {"loss": loss, "acc": acc}


def retrieval_scores(cfg: FMConfig, params, ids, cand, cand_bias,
                     rules: Optional[MeshRules] = None) -> torch.Tensor:
    """Score ONE query against Ncand candidates as a single batched dot:
    score(u, c) = const(u) + bias_c + <sum_f v_f(u), v_c>.  Over a mesh
    ``cand`` and ``cand_bias`` are the global candidates and each rank
    scores its block of them by their ``rows`` axis; the query's rows
    come from their owners (one routed gather)."""
    rules = rules or make_rules(None)
    ids = _ids(params, ids)
    if rules.mesh is None:
        rows = offload.dma_gather(params["table"], ids)         # (1, F, 1+k)
    else:
        mesh = rules.mesh.over(rules.flat)
        cand = rules.input_sharding(cand.shape, "rows", None).block(cand)
        cand_bias = rules.input_sharding(cand_bias.shape, "rows").block(
            cand_bias)
        if cfg.n_rows_padded % mesh.size:
            rows = offload.dma_gather(params["table"], ids)
        else:
            rows = offload.dgas_gather(
                params["table"], ids.reshape(-1),
                block_rule(cfg.n_rows_padded, mesh.size), mesh,
                capacity=ids.numel()).reshape(ids.shape + (-1,))
    v = rows[..., 1:].float()[0]                                # (F, k)
    u_vec = v.sum(0)                                            # (k,)
    u_const = (params["w0"] + rows[..., 0].sum()
               + 0.5 * ((u_vec ** 2).sum() - (v * v).sum()))
    cand = rules.constrain(cand, "rows", None)
    return u_const + cand_bias.float() + cand.float() @ u_vec
