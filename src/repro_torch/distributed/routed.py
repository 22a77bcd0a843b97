"""Collectives and DGAS exchanges under autograd, for training over a
process mesh.

The reference differentiates through ``shard_map``: each collective's
transpose is another collective.  These are the same pairs as
``torch.autograd.Function``s over a ``launch.mesh.Mesh`` (a 1-D mesh: the
caller picks it with ``Mesh.over(axes)``), on the owner-routed primitives
of ``core.offload``:

* :func:`all_reduce_sum` — forward and backward a sum over the ranks;
* :func:`all_gather_rows` — the blocks of every rank along a dim, in rank
  order; backward, the summed gradient's part at this rank's block (a
  reduce-scatter);
* :func:`reduce_scatter_rows` — this rank's block along a dim of the sum
  over the ranks; backward, the all-gathered gradient;
* :func:`all_to_all` — chunk p of every rank's tensor to rank p; backward,
  the same exchange of the gradient;
* :func:`gather` — the DGAS gather: each request routes to the row's
  owner and only the requested rows return; backward, the gradient rows
  travel back along the same slots and the owner sums them into its block
  (B4, or torch's ``index_add_``);
* :func:`scatter_add` — the DGAS remote add: (id, row) pairs route to the
  owner, which sums them into its block with B4; backward, a routed gather
  of the gradient at the same slots;
* :func:`global_mean` — a loss's mean over every rank's rows, carrying
  the gradient of this rank's share.

Each rank's gradient is its *share*: the gradient of the whole is the sum
of the ranks' gradients, as a loss from :func:`global_mean` gives it.  So
the LM's parallel layouts (``models/transformer.py``) need one collective
a region, and ``configs.common.reduce_grads`` sums every parameter's
gradient over the axes its placement does not split, whatever the layout:

* FSDP: a weight's ``embed`` dim is gathered over the batch axes
  (:func:`all_gather_rows`); its backward reduce-scatters the gradient,
  which is then whole over those axes;
* tensor parallel: a replicated activation enters a ``heads`` / ``ff`` /
  ``vocab`` region with no collective (its shares' sum is its gradient),
  and the region's partial sums leave it through :func:`all_reduce_sum`,
  whose backward sums the shares: the psum / psum transpose pair of the
  reference's ``shard_map``;
* sequence parallel: the residual stream's sequence is gathered over
  ``model`` entering a region (:func:`all_gather_rows`) and leaves it by
  :func:`reduce_scatter_rows`; an expert-parallel MoE sends each of its
  sequence block's tokens to its expert's rank and back
  (:func:`all_to_all`).

A collective over one rank is skipped.  A routed exchange keeps its slot bookkeeping (``offload.Route``: index
tensors, never rows) for its backward.  Every rank issues the same
collectives in the same order in the forward, the backward and the
recompute of ``torch.utils.checkpoint`` (which routes again, to the same
slots), whatever its block holds: a rank with nothing to send still
routes.
"""
from __future__ import annotations

import torch

from ..core import offload

__all__ = ["all_reduce_sum", "all_gather_rows", "reduce_scatter_rows",
           "all_to_all", "gather", "scatter_add", "global_mean"]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x, "sum")

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad, "sum"), None


def _block(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    per = x.shape[dim] // mesh.size
    return x.narrow(dim, mesh.rank * per, per).clone()


def _gather_dim(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    g = mesh.all_gather(x.contiguous())
    return torch.cat(list(g.unbind(0)), dim=dim)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _gather_dim(x, mesh, dim)

    @staticmethod
    def backward(ctx, grad):
        return _block(ctx.mesh.all_reduce(grad, "sum"), ctx.mesh,
                      ctx.dim), None, None


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _block(mesh.all_reduce(x, "sum"), mesh, dim)

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim(grad, ctx.mesh, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_to_all(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_to_all(grad.contiguous()), None


def all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
    """Chunk p of ``x`` (its leading dim split into ``mesh.size`` chunks)
    goes to rank p; chunk q of the result came from rank q.  Its gradient
    makes the same exchange back."""
    return x if mesh.size == 1 else _AllToAll.apply(x, mesh)


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks; its gradient is the sum of the
    ranks' gradients."""
    return x if mesh.size == 1 else _AllReduceSum.apply(x, mesh)


def all_gather_rows(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's block ``x`` concatenated along ``dim`` in rank order
    (the whole of a tensor split along ``dim``: a row-sharded table, an
    FSDP weight, a sequence-parallel activation)."""
    return x if mesh.size == 1 else _AllGatherRows.apply(x, mesh, dim)


def reduce_scatter_rows(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over the ranks
    (``dim`` divides into ``mesh.size`` blocks)."""
    if x.shape[dim] % mesh.size:
        raise ValueError(f"{x.shape[dim]} rows do not split into "
                         f"{mesh.size} blocks")
    return x if mesh.size == 1 else _ReduceScatterRows.apply(x, mesh, dim)


def _owner_sum(idx, rows, n, b4):
    """(n, ...) f32 sums of rows by idx at the owner, -1 dropped: B4, or
    torch's scatter."""
    if b4:
        return offload.segment_sum_rows(idx, rows, n)
    out = rows.new_zeros((n,) + tuple(rows.shape[1:]), dtype=torch.float32)
    return offload.dma_scatter_add(out, idx, rows)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, gidx, att, mesh, capacity, b4):
        route, _ = offload.dgas_requests(gidx, att, mesh, capacity=capacity)
        ctx.route, ctx.mesh, ctx.n, ctx.b4 = route, mesh, table.shape[0], b4
        ctx.dtype = table.dtype
        rows = offload.dma_gather(table, route.local)
        return offload.reply_along(rows, route, mesh)

    @staticmethod
    def backward(ctx, grad):
        at_owner = offload.send_along(grad.contiguous(), ctx.route, ctx.mesh)
        g = _owner_sum(ctx.route.local, at_owner, ctx.n, ctx.b4)
        return g.to(ctx.dtype), None, None, None, None, None


class _ScatterAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, gidx, att, mesh, capacity, n):
        route, (rows,) = offload.dgas_requests(gidx, att, mesh,
                                               capacity=capacity,
                                               payload=(vals,))
        ctx.route, ctx.mesh, ctx.dtype = route, mesh, vals.dtype
        return offload.segment_sum_rows(route.local, rows, n)

    @staticmethod
    def backward(ctx, grad):
        at_owner = offload.dma_gather(grad.contiguous(), ctx.route.local)
        g = offload.reply_along(at_owner, ctx.route, ctx.mesh)
        return g.to(ctx.dtype), None, None, None, None, None


def gather(table: torch.Tensor, gidx: torch.Tensor, att, mesh, *,
           capacity: int, b4: bool = True) -> torch.Tensor:
    """The rows of the global table at the global ids ``gidx`` (0 for an
    id outside it or a request past ``capacity``), this rank holding
    ``table``, its rows by ``att`` (``offload.dgas_gather``).  Backward:
    the gradient's rows return to the owners along the request slots and
    are summed there into the table's gradient, by B4 (``b4``) or torch's
    ``index_add_``."""
    return _Gather.apply(table, gidx, att, mesh, capacity, b4)


def scatter_add(vals: torch.Tensor, gidx: torch.Tensor, att, mesh, *,
                capacity: int, n: int) -> torch.Tensor:
    """This rank's (n, ...) float32 block of the global sums of ``vals``'
    rows by global id ``gidx`` (ids outside the global range, and requests
    past ``capacity``, dropped): the rows route to the owners, which sum
    them with B4 (``offload.segment_sum_rows``).  Backward: a routed
    gather of the gradient's rows at the same slots."""
    return _ScatterAdd.apply(vals, gidx, att, mesh, capacity, n)


def global_mean(total: torch.Tensor, metric: torch.Tensor, count,
                mesh) -> tuple:
    """(loss, metric) over every rank: ``total`` (differentiable) and
    ``metric`` summed over this rank's rows, ``count`` its rows.  Both are
    divided by the count of every rank's rows (at least 1), so the ranks'
    shares add up to the mean also where every rank holds every row.  The
    loss has the global mean's value and the gradient of this rank's
    share: the ranks' gradients add up to the mean's."""
    count = torch.as_tensor(count, dtype=torch.float32, device=total.device)
    count = torch.clamp(mesh.all_reduce(count.reshape(1), "sum")[0], min=1)
    share = total / count
    both = mesh.all_reduce(torch.stack([share.detach(), metric / count]),
                           "sum")
    return share + (both[0] - share).detach(), both[1]
