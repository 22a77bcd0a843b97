"""GNN architectures: GIN, GatedGCN, DimeNet, EquiformerV2 (eSCN)
(counterpart of ``repro.models.gnn``), forward, loss and gradients.

Message passing is a gather of node (or edge) rows and a segment sum of
messages into their destinations.  Both are autograd Functions over the
B4 kernel (``csrc/segment_sum.cu``, through ``kernels.ops
.segment_sum_sorted``): :func:`segment_sum`'s forward is B4 and its
backward a gather; :func:`gather_rows`' forward is a gather and its
backward B4.  On CPU tensors B4's wrapper computes the plain version, on
CUDA tensors it launches the kernel or raises.  B4 takes ids in any order,
so a CSR-ordered destination stream needs no sort.  The segment max of
the softmaxes is ``scatter_reduce('amax')`` and is kept out of the graph:
a softmax does not depend on the shift, so its gradient cancels.

Parameters are a nested dict / list tree with the reference's names;
where the reference stacks identical layers (``layers``, ``blocks``) for
``lax.scan``, the port keeps a list, one entry a layer
(:func:`params_from_reference` unstacks).  ``jax.checkpoint`` becomes
``torch.utils.checkpoint`` and a scan over edge or triplet chunks a loop
over the same chunks.  One device: gathers and scatters over a mesh (the
reference's DGAS exchange) wait for rules over a mesh and raise.

Batch schema (numpy arrays or tensors; moved to the parameters' device):

    x (N, F); src, dst (E,) int (-1 padding); labels (N,) int | (Bg,);
    label_mask (N,) bool; graph_id / node_mask (N,); pos (N, 3);
    wigner (E, (L+1)^2, (L+1)^2); triplet_kj, triplet_ji (T,) int;
    angle (T,)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.graph import resolve_device
from ..distributed.sharding import MeshRules, make_rules
from ..kernels import ops

__all__ = ["GNNConfig", "init_params", "forward", "loss_fn", "segment_sum",
           "gather_rows", "gather_nodes", "scatter_add_nodes",
           "params_from_reference", "batch_to"]

_MESH = ("gathers and scatters over a mesh (the DGAS exchange) are not "
         "ported yet: they wait for rules over a mesh (ROADMAP §A.9, "
         "slice 14)")


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    arch: str                    # gin | gatedgcn | dimenet | equiformer_v2
    n_layers: int
    d_hidden: int
    d_feat: int
    n_classes: int = 2
    task: str = "node"           # node | graph | regression
    # gin
    eps_learnable: bool = True
    # dimenet
    n_radial: int = 6
    n_spherical: int = 7
    n_bilinear: int = 8
    cutoff: float = 5.0
    # equiformer_v2
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    # memory blocking for huge graphs (None = unchunked): edges / triplets
    # are streamed in chunks so per-edge intermediates stay bounded
    edge_chunk: Optional[int] = None
    triplet_chunk: Optional[int] = None
    dtype: torch.dtype = torch.float32

    @property
    def n_coef(self) -> int:
        return (self.l_max + 1) ** 2


# ---------------------------------------------------------------------------
# B4 under autograd
# ---------------------------------------------------------------------------

def _b4(data: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """B4 on data (N, ...) -> (n, ...) f32; ids outside [0, n) dropped."""
    rows = data.reshape(data.shape[0], -1)
    out = ops.segment_sum_sorted(rows, seg, n)
    return out.reshape((n,) + tuple(data.shape[1:]))


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] in one pass, 0 where idx is outside [0, len(table)):
    the table gets one zero row, and those ids point at it."""
    n = table.shape[0]
    ext = torch.cat([table, table.new_zeros((1,) + tuple(table.shape[1:]))])
    safe = torch.where((idx >= 0) & (idx < n), idx, n).long()
    return ext[safe]


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, seg, n):
        ctx.save_for_backward(seg)
        return _b4(data, seg, n)

    @staticmethod
    def backward(ctx, grad):
        seg, = ctx.saved_tensors
        return _take(grad, seg), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        return _take(table, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        return _b4(grad, idx, ctx.n), None


def segment_sum(data: torch.Tensor, seg: torch.Tensor,
                n: int) -> torch.Tensor:
    """out[s] = sum of data's rows with seg == s, (n, ...) f32; ids
    outside [0, n), such as -1, are dropped.  Forward B4; backward
    grad[seg], 0 for a dropped row (``jax.ops.segment_sum``'s VJP)."""
    return _SegmentSum.apply(data.to(torch.float32), seg, n)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx], 0 where idx is outside [0, len(table)).  Backward: B4
    of the gradient's rows by idx (the gather's VJP, a scatter-add)."""
    return _GatherRows.apply(table, idx)


def gather_nodes(cfg: GNNConfig, x: torch.Tensor, idx: torch.Tensor,
                 rules: MeshRules) -> torch.Tensor:
    """x[idx] with padding (-1 -> 0 rows)."""
    if rules.mesh is not None:
        raise NotImplementedError(_MESH)
    return gather_rows(x, idx)


def scatter_add_nodes(cfg: GNNConfig, dest, idx: torch.Tensor,
                      vals: torch.Tensor, rules: MeshRules) -> torch.Tensor:
    """dest + the segment sum of vals by idx (idx < 0 dropped); dest an
    int n for a fresh zero buffer.  Out of place, so autograd sees it."""
    if rules.mesh is not None:
        raise NotImplementedError(_MESH)
    if isinstance(dest, int):
        return segment_sum(vals, idx, dest)
    return dest + segment_sum(vals, idx, dest.shape[0])


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

class _Init:
    """N(0, 1 / fan_in) draws in f32 from one generator (none on the meta
    device)."""

    def __init__(self, seed: int, device):
        self.dev = resolve_device(device)
        self.gen = (None if self.dev.type == "meta"
                    else torch.Generator(device=self.dev).manual_seed(seed))

    def dense(self, shape, fan_in=None):
        w = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.dev)
        return w.div_(math.sqrt(fan_in or shape[0]))

    def ones(self, *shape):
        return torch.ones(shape, dtype=torch.float32, device=self.dev)

    def zeros(self, *shape):
        return torch.zeros(shape, dtype=torch.float32, device=self.dev)

    def mlp(self, dims):
        return [{"w": self.dense((dims[i], dims[i + 1])),
                 "b": self.zeros(dims[i + 1])} for i in range(len(dims) - 1)]


def _mlp(params, x, act=F.relu):
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1:
            x = act(x)
    return x


def _rmsnorm(x, w, eps=1e-6):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * w


def _segment_max(scores, seg, n):
    """(n, ...) max of scores by seg (in range), -1e30 where none lands;
    no gradient (it only shifts a softmax)."""
    base = scores.new_full((n,) + tuple(scores.shape[1:]), -1e30)
    idx = seg.long().reshape((-1,) + (1,) * (scores.dim() - 1))
    return base.scatter_reduce(0, idx.expand_as(scores), scores.detach(),
                               "amax", include_self=True)


def _edge_head_softmax(alpha, valid, dst, n, n_heads):
    safe = torch.where(valid, dst, n)
    smax = _segment_max(torch.where(valid[:, None], alpha, -1e30), safe,
                        n + 1)
    ex = torch.exp(alpha - smax[safe.long()]) * valid[:, None]
    den = segment_sum(ex, safe, n + 1)
    return ex / torch.clamp(den[safe.long()], min=1e-20)


def _remat(fn, *args):
    """fn(*args), checkpointed when autograd records (jax.checkpoint)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# GIN
# ---------------------------------------------------------------------------

def _gin_init(cfg, ini):
    def one(d_in):
        return {"mlp": ini.mlp([d_in, cfg.d_hidden, cfg.d_hidden]),
                "eps": ini.zeros(), "ln": ini.ones(cfg.d_hidden)}
    return {"layer0": one(cfg.d_feat),
            "layers": [one(cfg.d_hidden) for _ in range(1, cfg.n_layers)],
            "readout": ini.mlp([cfg.d_hidden, cfg.n_classes])}


def _gin_forward(cfg, params, batch, rules):
    x = batch["x"].to(torch.float32)
    src, dst = batch["src"], batch["dst"]
    n = x.shape[0]
    mdst = torch.where(src >= 0, dst, -1)

    def layer(lyr, x):
        # gather gives 0 for src -1: the reference's `* valid`
        msg = gather_nodes(cfg, x, src, rules)
        agg = scatter_add_nodes(cfg, n, mdst, msg, rules)
        x = _mlp(lyr["mlp"], (1.0 + lyr["eps"]) * x + agg)
        return rules.constrain(_rmsnorm(x, lyr["ln"]), "nodes", None)

    for lyr in [params["layer0"]] + list(params["layers"]):
        x = _remat(layer, lyr, x)
    return x


# ---------------------------------------------------------------------------
# GatedGCN
# ---------------------------------------------------------------------------

def _gatedgcn_init(cfg, ini):
    d = cfg.d_hidden
    layers = [{"A": ini.dense((d, d)), "B": ini.dense((d, d)),
               "D": ini.dense((d, d)), "E": ini.dense((d, d)),
               "C": ini.dense((d, d)), "ln_h": ini.ones(d),
               "ln_e": ini.ones(d)} for _ in range(cfg.n_layers)]
    return {"embed": ini.dense((cfg.d_feat, d)), "edge_embed": ini.zeros(d),
            "layers": layers, "readout": ini.mlp([d, cfg.n_classes])}


def _gatedgcn_forward(cfg, params, batch, rules):
    src, dst = batch["src"], batch["dst"]
    n = batch["x"].shape[0]
    d = cfg.d_hidden
    h = batch["x"].to(torch.float32) @ params["embed"]
    e = params["edge_embed"].expand(src.shape[0], d)
    valid = (src >= 0)[:, None]
    mdst = torch.where(src >= 0, dst, -1)

    def layer(lyr, h, e):
        hs = gather_nodes(cfg, h, src, rules)
        hd = gather_nodes(cfg, h, dst, rules)
        e_new = e + F.relu(_rmsnorm(e @ lyr["C"] + hd @ lyr["D"]
                                    + hs @ lyr["E"], lyr["ln_e"]))
        eta = torch.sigmoid(e_new)
        msg = (eta * (hs @ lyr["B"])) * valid
        # numerator and denominator in one segment sum (columns apart)
        both = scatter_add_nodes(cfg, n, mdst,
                                 torch.cat([msg, eta * valid], -1), rules)
        agg = both[:, :d] / (both[:, d:] + 1e-6)
        h = h + F.relu(_rmsnorm(h @ lyr["A"] + agg, lyr["ln_h"]))
        return (rules.constrain(h, "nodes", None),
                rules.constrain(e_new, "edges", None))

    for lyr in params["layers"]:
        h, e = _remat(layer, lyr, h, e)
    return h


# ---------------------------------------------------------------------------
# DimeNet (directional message passing over triplets)
# ---------------------------------------------------------------------------

def _dimenet_init(cfg, ini):
    d = cfg.d_hidden
    sbf = cfg.n_radial * cfg.n_spherical
    blocks = [{"w_rbf": ini.dense((cfg.n_radial, d)),
               "w_sbf": ini.dense((sbf, cfg.n_bilinear)),
               "w_kj": ini.dense((d, cfg.n_bilinear)),
               "w_bil": ini.dense((cfg.n_bilinear, d)),
               "mlp": ini.mlp([d, d, d]), "out": ini.mlp([d, d])}
              for _ in range(cfg.n_layers)]
    n_out = cfg.n_classes if cfg.task != "regression" else 1
    return {"embed": ini.mlp([2 * cfg.d_feat + cfg.n_radial, d]),
            "blocks": blocks, "readout": ini.mlp([d, n_out])}


def _rbf(dist, n_radial, cutoff):
    """Sine radial basis (DimeNet eq. 6): sqrt(2/c) sin(n pi d / c) / d."""
    nn_ = torch.arange(1, n_radial + 1, dtype=torch.float32,
                       device=dist.device)
    d = torch.clamp(dist, min=1e-3)[:, None]
    return np.sqrt(2.0 / cutoff) * torch.sin(nn_ * np.pi * d / cutoff) / d


def _sbf(dist, angle, n_radial, n_spherical, cutoff):
    """Fourier product basis over (distance, angle)."""
    rad = _rbf(dist, n_radial, cutoff)                         # (T, nr)
    ls = torch.arange(n_spherical, dtype=torch.float32, device=dist.device)
    ang = torch.cos(ls[None, :] * angle[:, None])              # (T, ns)
    return (rad[:, :, None] * ang[:, None, :]).reshape(dist.shape[0], -1)


def _chunks(chunk: int, total: int, *cols):
    """cols padded (first with -1, the rest with 0) to a multiple of
    chunk, as per-chunk lists."""
    pad = -(-total // chunk) * chunk - total
    out = []
    for i, c in enumerate(cols):
        if pad:
            fill = c.new_full((pad,) + tuple(c.shape[1:]), -1 if i == 0 else 0)
            c = torch.cat([c, fill])
        out.append(list(c.split(chunk)))
    return list(zip(*out))


def _dimenet_forward(cfg, params, batch, rules):
    src, dst, pos = batch["src"], batch["dst"], batch["pos"]
    x = batch["x"].to(torch.float32)
    n, E, d = x.shape[0], src.shape[0], cfg.d_hidden
    valid_e = src >= 0
    d_vec = (gather_nodes(cfg, pos, dst, rules)
             - gather_nodes(cfg, pos, src, rules))
    dist = torch.sqrt(torch.sum(d_vec ** 2, -1) + 1e-9)
    rbf = _rbf(dist, cfg.n_radial, cfg.cutoff) * valid_e[:, None]
    m = _mlp(params["embed"], torch.cat(
        [gather_nodes(cfg, x, src, rules), gather_nodes(cfg, x, dst, rules),
         rbf], -1))
    m = m * valid_e[:, None]

    t_kj, t_ji, angle = batch["triplet_kj"], batch["triplet_ji"], batch["angle"]
    T = t_kj.shape[0]
    tri_chunks = _chunks(cfg.triplet_chunk or T, T, t_kj, t_ji, angle)
    out_dst = torch.where(valid_e, dst, -1)

    def block(blk, m, node_out):
        # triplet gather: message of edge kj modulated by the angular basis
        # -> edge ji, in chunks so the (T, d) intermediates stay bounded
        agg = None
        for kj, ji, ang in tri_chunks:
            vt = kj >= 0
            sbf = _sbf(gather_nodes(cfg, dist, kj, rules), ang, cfg.n_radial,
                       cfg.n_spherical, cfg.cutoff) * vt[:, None]
            m_kj = gather_nodes(cfg, m, kj, rules)
            tri = (m_kj @ blk["w_kj"]) * (sbf @ blk["w_sbf"])
            tri = (tri @ blk["w_bil"]) * vt[:, None]
            agg = scatter_add_nodes(cfg, E if agg is None else agg,
                                    torch.where(vt, ji, -1), tri, rules)
        m = m + _mlp(blk["mlp"], m * (rbf @ blk["w_rbf"]) + agg)
        m = rules.constrain(m * valid_e[:, None], "edges", None)
        # per-block output: edges -> dst nodes
        node_out = node_out + scatter_add_nodes(
            cfg, n, out_dst, _mlp(blk["out"], m), rules)
        return m, node_out

    node_out = x.new_zeros((n, d))
    for blk in params["blocks"]:
        m, node_out = _remat(block, blk, m, node_out)
    return node_out


# ---------------------------------------------------------------------------
# EquiformerV2 (eSCN SO(2) convolutions, graph attention)
# ---------------------------------------------------------------------------

def _so2_index_sets(l_max, m_max):
    """Flat irrep index (l^2+l+m) groups per |m| <= m_max."""
    sets = []
    for m in range(m_max + 1):
        pos = [l * l + l + m for l in range(m, l_max + 1)]
        neg = [l * l + l - m for l in range(m, l_max + 1)]
        sets.append((pos, neg))
    return sets


def _equiformer_init(cfg, ini):
    C = cfg.d_hidden
    layers = []
    for _ in range(cfg.n_layers):
        so2 = []
        for m in range(cfg.m_max + 1):
            nl = cfg.l_max + 1 - m
            blk = {"wr": ini.dense((nl * C, nl * C), nl * C)}
            if m > 0:
                blk["wi"] = ini.dense((nl * C, nl * C), nl * C)
            so2.append(blk)
        layers.append({
            "so2": so2,
            "alpha": ini.mlp([2 * C, C, cfg.n_heads]),
            "gate": ini.mlp([C, (cfg.l_max + 1) * C]),
            "ln": ini.ones(C),
            "ffn_gate": ini.mlp([C, (cfg.l_max + 1) * C]),
            "ffn": ini.dense((C, C)),
            "proj": ini.dense((C, C)),
        })
    n_out = cfg.n_classes if cfg.task != "regression" else 1
    return {"embed": ini.dense((cfg.d_feat, C)), "layers": layers,
            "readout": ini.mlp([C, n_out])}


def _so2_conv(x_rot, so2_params, idx_sets, C):
    """x_rot (E, ncoef, C): SO(2) conv mixing l within each |m| block."""
    out = torch.zeros_like(x_rot)
    for m, (pos, neg) in enumerate(idx_sets):
        nl = len(pos)
        xp = x_rot[:, pos, :].reshape(-1, nl * C)
        wr = so2_params[m]["wr"]
        if m == 0:
            out[:, pos, :] = (xp @ wr).reshape(-1, nl, C)
        else:
            wi = so2_params[m]["wi"]
            xn = x_rot[:, neg, :].reshape(-1, nl * C)
            out[:, pos, :] = (xp @ wr - xn @ wi).reshape(-1, nl, C)
            out[:, neg, :] = (xp @ wi + xn @ wr).reshape(-1, nl, C)
    return out


def _equiformer_forward(cfg, params, batch, rules):
    src, dst = batch["src"], batch["dst"]
    wig = batch["wigner"].to(torch.float32)      # (E, ncoef, ncoef)
    n, E = batch["x"].shape[0], src.shape[0]
    C, ncoef = cfg.d_hidden, cfg.n_coef
    valid = src >= 0
    idx_sets = _so2_index_sets(cfg.l_max, cfg.m_max)

    # invariant features in l = 0; higher l start at 0
    x0 = batch["x"].to(torch.float32) @ params["embed"]
    X = torch.cat([x0[:, None, :], x0.new_zeros((n, ncoef - 1, C))], 1)
    l_ids = torch.tensor(np.concatenate(
        [[l] * (2 * l + 1) for l in range(cfg.l_max + 1)]),
        device=X.device)

    chunk = cfg.edge_chunk or E
    pad = -(-E // chunk) * chunk - E
    edge_chunks = _chunks(chunk, E, src, dst, wig)   # padding: src -1

    def layer_fn(X, lyr):
        # pass A: attention logits from the invariant (l = 0) features
        alpha = torch.cat([_mlp(lyr["alpha"], torch.cat(
            [gather_nodes(cfg, X[:, 0, :], d, rules),
             gather_nodes(cfg, X[:, 0, :], s, rules)], -1))
            for s, d, _ in edge_chunks])[:E]
        alpha = _edge_head_softmax(alpha, valid, dst, n, cfg.n_heads)
        a_mean = alpha.mean(-1)
        if pad:
            a_mean = torch.cat([a_mean, a_mean.new_zeros(pad)])
        alpha_c = a_mean.split(chunk)

        # pass B: eSCN messages, streamed; aggregation = segment sum
        def msg_body(X, s, d, w, a):
            vmask = s >= 0
            Xi = gather_nodes(cfg, X, d, rules)
            Xj = gather_nodes(cfg, X, s, rules)
            msg = _so2_conv(torch.bmm(w, Xi) + torch.bmm(w, Xj), lyr["so2"],
                            idx_sets, C)             # rotated to edge frame
            gate = _mlp(lyr["gate"], msg[:, 0, :]).reshape(-1, cfg.l_max + 1,
                                                           C)
            msg = msg * torch.sigmoid(gate)[:, l_ids, :]
            msg = msg * a[:, None, None]
            back = torch.bmm(w.transpose(1, 2), msg)  # rotate back (D^T)
            back = back * vmask[:, None, None]
            return scatter_add_nodes(cfg, n, torch.where(vmask, d, -1), back,
                                     rules)

        agg = None
        for (s, d, w), a in zip(edge_chunks, alpha_c):
            part = _remat(msg_body, X, s, d, w, a)
            agg = part if agg is None else agg + part
        agg = rules.constrain(agg, "nodes", None, None)
        X = X + agg @ lyr["proj"]
        # equivariant FFN: per-l gated by a scalar MLP
        g = _mlp(lyr["ffn_gate"], _rmsnorm(X[:, 0, :], lyr["ln"]))
        g = torch.sigmoid(g.reshape(n, cfg.l_max + 1, C))[:, l_ids, :]
        X = X + (X @ lyr["ffn"]) * g
        return rules.constrain(X, "nodes", None, None)

    for lyr in params["layers"]:
        X = layer_fn(X, lyr)
    return X[:, 0, :]


# ---------------------------------------------------------------------------
# shared entry points
# ---------------------------------------------------------------------------

_FWD = {"gin": _gin_forward, "gatedgcn": _gatedgcn_forward,
        "dimenet": _dimenet_forward, "equiformer_v2": _equiformer_forward}
_INIT = {"gin": _gin_init, "gatedgcn": _gatedgcn_init,
         "dimenet": _dimenet_init, "equiformer_v2": _equiformer_init}


def init_params(cfg: GNNConfig, seed: int = 0, *, device=None) -> dict:
    """The reference's parameter tree (layers as a list), every leaf f32,
    drawn from ``seed`` on ``device`` (CUDA by default; ``meta`` for the
    shapes alone)."""
    return _INIT[cfg.arch](cfg, _Init(seed, device))


def _to_torch(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_reference(cfg: GNNConfig, tree: dict, *,
                          device=None) -> dict:
    """The reference's tree (numpy-convertible leaves; ``layers`` /
    ``blocks`` stacked on a leading axis) as this module's parameters on
    ``device``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _to_torch(node).to(dev)

    def unstack(node, i):
        if isinstance(node, dict):
            return {k: unstack(v, i) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [unstack(v, i) for v in node]
        return np.asarray(node)[i]

    out = {}
    for k, v in tree.items():
        if k in ("layers", "blocks"):
            count = len(np.asarray(_first_leaf(v)))
            out[k] = [conv(unstack(v, i)) for i in range(count)]
        else:
            out[k] = conv(v)
    return out


def _first_leaf(node):
    while isinstance(node, (dict, list, tuple)):
        node = next(iter(node.values())) if isinstance(node, dict) else node[0]
    return node


def _device(params) -> torch.device:
    return params["readout"][0]["w"].device


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def batch_to(batch: dict, device) -> dict:
    """The batch's arrays as tensors on ``device`` (dtypes kept)."""
    return {k: _tensor(v).to(device) for k, v in batch.items()}


def forward(cfg: GNNConfig, params, batch, rules: Optional[MeshRules] = None):
    """Per-node hidden -> logits / outputs after the readout (per graph
    for a graph or regression task with ``graph_id``)."""
    rules = rules or make_rules(None)
    batch = batch_to(batch, _device(params))
    h = _FWD[cfg.arch](cfg, params, batch, rules)
    gid = batch.get("graph_id")
    if gid is not None and cfg.task in ("graph", "regression"):
        nm = batch.get("node_mask")
        if nm is not None:   # padded nodes contribute nothing to the readout
            h = h * nm[:, None].to(h.dtype)
        h = segment_sum(h, gid, int(batch["labels"].shape[0]))
    return _mlp(params["readout"], h)


def loss_fn(cfg: GNNConfig, params, batch, rules: Optional[MeshRules] = None):
    """(loss, metrics): mean squared error for regression, masked
    cross-entropy and accuracy otherwise."""
    batch = batch_to(batch, _device(params))
    out = forward(cfg, params, batch, rules)
    labels = batch["labels"]
    if cfg.task == "regression":
        loss = torch.mean((out[..., 0] - labels.to(torch.float32)) ** 2)
        return loss, {"loss": loss}
    logp = F.log_softmax(out.to(torch.float32), -1)
    nll = -logp.gather(1, labels[:, None].long())[:, 0]
    mask = batch.get("label_mask")
    hit = (out.argmax(-1) == labels).to(torch.float32)
    if mask is not None:
        cnt = torch.clamp(mask.sum(), min=1)
        loss = torch.where(mask, nll, 0.0).sum() / cnt
        acc = torch.where(mask, hit, 0.0).sum() / cnt
    else:
        loss, acc = nll.mean(), hit.mean()
    return loss, {"loss": loss, "acc": acc}
