"""SpMSpV: sparse-matrix x sparse-vector (paper Table II), torch.

y = A^T x_s for a sparse input vector x_s = {(id_i, val_i)}.  Work is
proportional to the edges of *active* vertices only: fine-grained row
gathers + scatter-adds, no dense pass.
"""
from __future__ import annotations

import torch

from ..graph import CSR
from ..engine import _gather_rows
from .. import offload

__all__ = ["spmspv", "spmspv_ell"]


def spmspv(csr: CSR, ids: torch.Tensor, vals: torch.Tensor, *,
           max_deg: int | None = None) -> torch.Tensor:
    """Dense output y (n_cols,) f32. `ids` padded with -1, `vals` 0 on
    padding; each active row contributes at most `max_deg` entries (all
    when None).

    The active rows' adjacency is expanded as one flat edge stream (no
    (ids, max degree) block), then scatter-added."""
    safe = torch.clamp(ids, min=0).long()
    deg = (csr.indptr[safe + 1] - csr.indptr[safe]).long()
    deg = torch.where(ids >= 0, deg, torch.zeros_like(deg))
    if max_deg is not None:
        deg = torch.clamp(deg, max=int(max_deg))
    seg, cols, w = _gather_rows(csr.indptr, csr.indices, csr.values, ids,
                                int(deg.sum()), max_deg)
    mvals = w if w is not None else torch.ones(
        cols.shape[0], dtype=torch.float32, device=cols.device)
    y = torch.zeros(csr.n_cols, dtype=torch.float32, device=cols.device)
    return offload.dma_scatter_add(y, cols, mvals * vals[seg])


def spmspv_ell(ell_cols: torch.Tensor, ell_vals: torch.Tensor,
               ell_mask: torch.Tensor, n_cols: int, ids: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
    """Same, but from a prebuilt padded-ELL matrix (kernel-friendly layout)."""
    safe = torch.clamp(ids, min=0)
    cols = offload.dma_gather(ell_cols, safe)            # (k_active, k)
    mv = offload.dma_gather(ell_vals, safe)
    mask = offload.dma_gather(ell_mask, safe) & (ids >= 0)[:, None]
    contrib = torch.where(mask, mv * vals[:, None], 0.0)
    y = torch.zeros(n_cols, dtype=torch.float32, device=contrib.device)
    return offload.dma_scatter_add(y, torch.where(mask, cols, -1), contrib)
