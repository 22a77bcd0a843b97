"""Error-feedback gradient compression for the data-parallel all-reduce
(counterpart of ``repro.optim.compression``), on a ``launch.mesh.Mesh``.

Two levels, each a sum of every rank's gradients:

* :func:`psum_bf16` — a bf16 all-reduce: half the bytes of f32, no state;
* :func:`psum_int8_ef` — int8 payloads and error feedback: each rank
  quantizes its gradient plus the residual it carried (:func:`_quant_int8`,
  one scale a tensor), keeps the new residual, and the payloads are summed
  as int32 and dequantized with the ranks' largest scale.  The reference
  casts each payload to int32 and sums it with ``psum``; here the int8
  payloads are all-gathered and summed as int32 on each rank, the same
  integers, so the mesh's counters see a quarter of the f32 bytes go in.

Both return the **sum** over the ranks, as the reference's do (its
``psum_int8_ef`` docstring says "averaged"; its code sums).  A gradient
tree is a dict (or list) of tensors, or a tensor.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

__all__ = ["psum_bf16", "psum_int8_ef", "init_ef_state"]


def _map(fn, *trees):
    head = trees[0]
    if isinstance(head, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def psum_bf16(grads, mesh):
    """Each gradient summed over the ranks in bf16, cast back to its
    dtype."""
    return _map(lambda g: mesh.all_reduce(g.to(torch.bfloat16),
                                          "sum").to(g.dtype), grads)


def init_ef_state(grads_shape) -> Any:
    """Zero f32 residuals shaped like the gradients."""
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads_shape)


def _quant_int8(x: torch.Tensor):
    """(q int8, scale): scale = max |x| / 127 + 1e-12, q = x / scale
    rounded half to even and clipped to [-127, 127] — the reference's
    arithmetic in f32."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def psum_int8_ef(grads, ef, mesh) -> Tuple[Any, Any]:
    """(summed gradients, new error-feedback state): each rank sends its
    int8 payload once (an all-gather summed as int32) and its scale
    (reduced by max)."""

    def one(g, e):
        x = g.to(torch.float32) + e
        q, scale = _quant_int8(x)
        new_e = x - q.to(torch.float32) * scale
        qsum = mesh.all_gather(q).to(torch.int32).sum(0)
        smax = mesh.all_reduce(scale.reshape(1), "max")[0]
        return (qsum.to(torch.float32) * smax).to(g.dtype), new_e

    out = _map(one, grads, ef)
    return _pick(out, grads, 0), _pick(out, grads, 1)


def _pick(tree, like, i):
    """Item i of each leaf pair of ``tree``, which has ``like``'s
    structure."""
    if isinstance(like, dict):
        return {k: _pick(tree[k], like[k], i) for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_pick(t, x, i) for t, x in zip(tree, like))
    return tree[i]
