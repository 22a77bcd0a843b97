"""SpMV — the paper's §V.A case study, local versions (torch).

  spmv        — fine-grained gather + owner-side reduction (paper's base loop)
  spmv_ell    — padded-row vectorized variant
  spmv_bbcsr  — the BBCSR kernel (kernels/spmv_dma.py, csrc/bbcsr.cu)
"""
from __future__ import annotations

import torch

from ..graph import CSR, BBCSR
from .. import offload

__all__ = ["spmv", "spmv_ell", "spmv_bbcsr"]


def spmv(csr: CSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x via fine-grained gather + segment reduction."""
    vals = csr.values if csr.values is not None else torch.ones(
        csr.nnz, dtype=x.dtype, device=x.device)
    contrib = vals * offload.dma_gather(x, csr.indices)
    y = torch.zeros(csr.n_rows, dtype=contrib.dtype, device=x.device)
    return y.index_add_(0, csr.row_ids(), contrib)


def spmv_ell(cols: torch.Tensor, vals: torch.Tensor, mask: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Padded-ELL SpMV: (n_rows, k) layout, one masked gather + row reduce."""
    gathered = offload.dma_gather(x, cols)
    return torch.where(mask, vals * gathered, 0.0).sum(dim=1)


def spmv_bbcsr(bb: BBCSR, x: torch.Tensor) -> torch.Tensor:
    from ...kernels import ops as kops
    return kops.spmv_dma(bb, x)
