"""ArchConfig + per-family shape tables + input_specs + step functions
(counterpart of ``repro.configs.common``).

Every (architecture x input-shape) cell resolves here to a model config
(shape-adapted for the GNN shapes), a batch of specs with their logical
sharding axes, a step function (train / prefill / decode / serve /
retrieval), and the training state's structure and logical axes.  A spec
is a tensor on the ``meta`` device: it has the shape and the
``torch.dtype`` of the input and holds no memory.  A decode cell's cache
spec is :func:`transformer.init_cache` on the meta device: per-layer
lists, (B, Kv, Smax, hd) for GQA, where the reference stacks (G, P, B,
Smax, Kv, hd).  Logical axes are keyed by parameter name (the names of
``optim.adamw.named_params``).

Over a process mesh (``rules`` from ``make_rules(mesh)``),
:func:`param_shardings` gives each parameter the ``Placement`` its
logical axes give it: a GNN's parameters are whole on every rank, FM's
table is row-sharded over the flat axes, an LM's weights are FSDP over
the batch axes and tensor or expert parallel over ``model`` by the
reference's table (``transformer.param_logical_axes``).  Every train step
runs on every rank from the global batch (the models slice it) or, for a
GNN, the rank's block of it (``gnn.local_batch``, what the launcher and
the dry run hand each rank) and sums each gradient over the axes its
parameter is not split over.  An LM's tokens and FM's ids stay whole on
every rank: a few MB even at ``prefill_32k`` (32 x 32,768 int32, 4 MB).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..distributed.sharding import MeshRules
from ..models import gnn as GNN
from ..models import recsys as RS
from ..models import transformer as TF
from ..optim import adamw

__all__ = ["ArchConfig", "SpecBundle", "LM_SHAPES", "GNN_SHAPES",
           "RECSYS_SHAPES", "VARIANTS", "shape_names", "input_specs",
           "apply_variant", "init_params", "param_logical_axes",
           "make_step", "state_shapes", "state_logical_axes",
           "param_shardings", "state_shardings", "reduce_grads"]


def S(shape, dtype) -> torch.Tensor:
    """A spec: a meta tensor of this shape and dtype."""
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # lm | gnn | recsys
    model: Any
    smoke: Any
    moment_dtype: Any = torch.float32
    skips: Dict[str, str] = dataclasses.field(default_factory=dict)
    notes: str = ""


@dataclasses.dataclass
class SpecBundle:
    kind: str                        # train | prefill | decode | serve | retrieval
    model: Any                       # possibly shape-adapted model config
    batch: Dict[str, Any]            # name -> meta tensor
    batch_axes: Dict[str, tuple]     # name -> logical axes
    cache: Optional[Dict[str, Any]] = None
    cache_axes: Optional[Dict[str, tuple]] = None


LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}
GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n=2708, e=10556, d_feat=1433, classes=7),
    "minibatch_lg": dict(kind="train", n=169984, e=168960, d_feat=602,
                         classes=41, masked=True),
    "ogb_products": dict(kind="train", n=2449029, e=61859140, d_feat=100,
                         classes=47),
    "molecule": dict(kind="train", n=3840, e=8192, d_feat=11, graphs=128,
                     task="regression"),
}
RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_cand=1_000_000),
}

_FAMILY_SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}


def shape_names(ac: ArchConfig):
    return list(_FAMILY_SHAPES[ac.family].keys())


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def _lm_specs(ac: ArchConfig, shape_name: str) -> SpecBundle:
    sh = LM_SHAPES[shape_name]
    cfg: TF.LMConfig = ac.model
    B, L = sh["batch"], sh["seq"]
    if sh["kind"] in ("train", "prefill"):
        return SpecBundle(sh["kind"], cfg, {"tokens": S((B, L), torch.int32)},
                          {"tokens": ("batch", None)})
    # decode: cache of seq_len (ring = window for SWA long-context)
    max_len = L
    if shape_name == "long_500k":
        assert cfg.window is not None, \
            "long_500k requires sub-quadratic attention"
        max_len = cfg.window
    cache = TF.init_cache(cfg, B, max_len, device="meta")
    if cfg.mla is not None:
        cache_axes = {"ckv": ("batch", "seq_kv", None),
                      "krope": ("batch", "seq_kv", None), "len": ()}
    else:
        cache_axes = {"k": ("batch", None, "seq_kv", None),
                      "v": ("batch", None, "seq_kv", None), "len": ()}
    return SpecBundle("decode", cfg, {"tokens": S((B, 1), torch.int32)},
                      {"tokens": ("batch", None)}, cache=cache,
                      cache_axes=cache_axes)


def _pad512(x: int) -> int:
    """Pad dims to a multiple of 512 so both production meshes divide them
    (padding edges carry src = dst = -1, padding nodes are masked)."""
    return -(-x // 512) * 512


def _gnn_specs(ac: ArchConfig, shape_name: str) -> SpecBundle:
    sh = GNN_SHAPES[shape_name]
    cfg: GNN.GNNConfig = ac.model
    n, e, f = _pad512(sh["n"]), _pad512(sh["e"]), sh["d_feat"]
    task = sh.get("task", "node")
    cfg = dataclasses.replace(
        cfg, d_feat=f, n_classes=sh.get("classes", 2), task=task,
        # memory blocking for the big shapes
        edge_chunk=(262144 if e > 1_000_000 else None),
        triplet_chunk=(1_048_576 if e > 1_000_000 else None))
    batch = {"x": S((n, f), torch.float32), "src": S((e,), torch.int32),
             "dst": S((e,), torch.int32)}
    if task == "regression":
        batch["labels"] = S((sh["graphs"],), torch.float32)
    else:
        batch["labels"] = S((n,), torch.int32)
        # padded nodes are always masked out of the loss
        batch["label_mask"] = S((n,), torch.bool)
    if sh.get("graphs"):
        batch["graph_id"] = S((n,), torch.int32)
        batch["node_mask"] = S((n,), torch.bool)
    if cfg.arch in ("dimenet", "equiformer_v2"):
        batch["pos"] = S((n, 3), torch.float32)
    if cfg.arch == "dimenet":
        t = min(4 * e, 256_000_000)
        batch["triplet_kj"] = S((t,), torch.int32)
        batch["triplet_ji"] = S((t,), torch.int32)
        batch["angle"] = S((t,), torch.float32)
    if cfg.arch == "equiformer_v2":
        nc = cfg.n_coef
        batch["wigner"] = S((e, nc, nc), torch.float32)
    every = GNN.batch_axes(cfg)
    axes = {k: every[k] for k in batch}
    return SpecBundle("train", cfg, batch, axes)


def _recsys_specs(ac: ArchConfig, shape_name: str) -> SpecBundle:
    sh = RECSYS_SHAPES[shape_name]
    cfg: RS.FMConfig = ac.model
    B = sh["batch"]
    if sh["kind"] == "retrieval":
        ncand = _pad512(sh["n_cand"])
        batch = {"ids": S((1, cfg.n_fields), torch.int32),
                 "cand": S((ncand, cfg.embed_dim), torch.float32),
                 "cand_bias": S((ncand,), torch.float32)}
        axes = {"ids": (None, None), "cand": ("rows", None),
                "cand_bias": ("rows",)}
        return SpecBundle("retrieval", cfg, batch, axes)
    batch = {"ids": S((B, cfg.n_fields), torch.int32)}
    axes = {"ids": ("batch", None)}
    if sh["kind"] == "train":
        batch["labels"] = S((B,), torch.float32)
        axes["labels"] = ("batch",)
        return SpecBundle("train", cfg, batch, axes)
    return SpecBundle("serve", cfg, batch, axes)


def input_specs(ac: ArchConfig, shape_name: str) -> SpecBundle:
    if shape_name in ac.skips:
        raise ValueError(f"{ac.name} skips {shape_name}: "
                         f"{ac.skips[shape_name]}")
    return {"lm": _lm_specs, "gnn": _gnn_specs,
            "recsys": _recsys_specs}[ac.family](ac, shape_name)


# Named model-config transforms (the reference's dryrun --variant X)
VARIANTS = {
    # PIUMA fine-grained embedding exchange instead of a gather
    "fm_dgas": lambda m: dataclasses.replace(m, use_dgas=True),
    # halve DGAS all_to_all buffer capacity (graph models and FM)
    "dgas_cap2": lambda m: dataclasses.replace(m, dgas_cap_factor=2),
    # larger / smaller edge streaming chunks (graph models)
    "chunk_512k": lambda m: dataclasses.replace(m, edge_chunk=524288),
    "chunk_128k": lambda m: dataclasses.replace(m, edge_chunk=131072),
    # Megatron-style fused QKV + fused gate matmuls (LM)
    "fused_qkv": lambda m: dataclasses.replace(m, fused_qkv=True),
}


def apply_variant(bundle: SpecBundle, variant: Optional[str]) -> SpecBundle:
    if not variant:
        return bundle
    bundle.model = VARIANTS[variant](bundle.model)
    return bundle


# ---------------------------------------------------------------------------
# params / state
# ---------------------------------------------------------------------------

def init_params(ac: ArchConfig, model_cfg, seed: int = 0, *, device=None,
                shardings: Optional[dict] = None):
    """An LM's :class:`~repro_torch.models.transformer.Transformer`, or a
    GNN's or FM's parameter tree, drawn from ``seed`` on ``device`` (CUDA
    by default; ``meta`` for the shapes alone).  An LM over a mesh keeps
    only this rank's blocks of its draws (``shardings``, as
    :func:`param_shardings` gives them)."""
    if ac.family == "lm":
        return TF.init_params(model_cfg, seed, device=device,
                              shardings=shardings)
    if ac.family == "gnn":
        return GNN.init_params(model_cfg, seed, device=device)
    return RS.init_params(model_cfg, seed, device=device)


def param_logical_axes(ac: ArchConfig, model_cfg, params_shape) -> dict:
    """{parameter name: logical axes}."""
    if ac.family == "lm":
        return TF.param_logical_axes(model_cfg)
    if ac.family == "recsys":
        return {"table": ("rows", None), "w0": ()}
    # gnn params are small: replicate
    return {k: (None,) * p.dim()
            for k, p in adamw.named_params(params_shape).items()}


def state_shapes(ac: ArchConfig, model_cfg, seed: int = 0):
    """(parameters, TrainState) on the meta device: the shapes and dtypes
    a train step holds, moments in the architecture's moment dtype."""
    params_shape = init_params(ac, model_cfg, seed, device="meta")
    return params_shape, adamw.init_state_with_dtype(params_shape,
                                                     ac.moment_dtype)


def state_logical_axes(ac: ArchConfig, model_cfg, params_shape):
    pax = param_logical_axes(ac, model_cfg, params_shape)
    return adamw.TrainState(params=pax, m=pax, v=pax, step=())


def param_shardings(rules: MeshRules, params_shape, pax) -> dict:
    """{parameter name: Placement} from each parameter's whole shape
    (``params_shape``: the parameters, or their meta specs) and logical
    axes (``pax``), by ``rules.input_sharding``: a dim the axes do not
    divide stays whole.  None for every parameter on one device."""
    if rules is None or rules.mesh is None:
        return {k: None for k in pax}
    named = adamw.named_params(params_shape)
    return {k: rules.input_sharding(tuple(named[k].shape), *(ax or ()))
            for k, ax in pax.items()}


def state_shardings(shardings: dict) -> adamw.TrainState:
    """The placements of a ``TrainState`` over parameters placed by
    ``shardings`` (moments as their parameters, ``step`` whole), the form
    ``checkpoint.restore`` and ``fault_tolerance.reshard_state`` take."""
    return adamw.TrainState(params=shardings, m=shardings, v=shardings,
                            step=None)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def reduce_grads(named: dict, shardings: dict, mesh) -> None:
    """Sum each parameter's gradient over the ranks that hold the same
    block of it (every rank for a replicated one, none for one split over
    every axis), in place: one all-reduce per set of such axes, of the
    gradients flattened together."""
    groups: dict = {}
    for k, p in named.items():
        pl = shardings.get(k)
        split = () if pl is None else pl.axes
        over = tuple(a for a in mesh.axis_names if a not in split)
        if over and p.grad is not None:
            groups.setdefault(over, []).append(p)
    for over, ps in groups.items():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        flat = mesh.over(over).all_reduce(flat, "sum")
        for p, g in zip(ps, flat.split([p.numel() for p in ps])):
            p.grad = g.view_as(p.grad).to(p.grad.dtype)

def make_step(ac: ArchConfig, bundle: SpecBundle, rules: MeshRules,
              opt=None) -> Callable:
    """The step for this cell:

    train:      step(state, batch) -> (state, metrics)
    prefill:    step(params, batch) -> (logits, cache)
    decode:     step(params, cache, batch) -> (logits, cache)
    serve:      step(params, batch) -> scores
    retrieval:  step(params, batch) -> scores

    ``params`` is what :func:`init_params` returns, ``state`` an
    ``optim.adamw.TrainState`` over it.  The train step reads the
    parameters from ``state.params`` (so a restored state is the one it
    trains), runs the loss forward and backward and applies AdamW in
    place; metrics are detached tensors on the device.

    Over a mesh every rank calls the step with the global batch (a GNN's
    may be the rank's ``gnn.RankBatch``) and its blocks of the state
    (``fault_tolerance.reshard_state`` of the whole parameters; an LM's
    :class:`~repro_torch.models.transformer.Transformer` drawn or placed
    with its placements); the loss carries each rank's
    share, so each parameter's gradient is summed over the mesh axes its
    placement does not split (:func:`reduce_grads`; an FSDP block's sum
    over the batch axes is its gather's backward) before the update.
    Prefill and decode run on every rank with the whole batch and give
    the whole logits."""
    cfg = bundle.model
    if bundle.kind == "train":
        opt = opt or adamw.AdamWConfig()
        loss_fn = {"lm": TF.loss_fn, "gnn": GNN.loss_fn,
                   "recsys": RS.loss_fn}[ac.family]
        meshed = rules is not None and rules.mesh is not None
        shardings = None
        if meshed and ac.family != "lm":
            params_shape, _ = state_shapes(ac, cfg)
            shardings = param_shardings(
                rules, params_shape,
                param_logical_axes(ac, cfg, params_shape))

        def step(state, batch):
            named = adamw.named_params(state.params)
            for p in named.values():
                p.grad = None
            with torch.enable_grad():
                loss, metrics = loss_fn(cfg, state.params, batch, rules)
                loss.backward()
            # an LM's blocks lie as its own placements say
            sh = state.params.placements if meshed and ac.family == "lm" \
                else shardings
            if sh is not None:
                reduce_grads(named, sh, rules.mesh)
            adamw.apply_update(opt, state, sh)
            return state, {k: v.detach() for k, v in metrics.items()}
        return step
    if bundle.kind == "prefill":
        return lambda params, batch: TF.prefill(cfg, params, batch["tokens"],
                                                rules)
    if bundle.kind == "decode":
        return lambda params, cache, batch: TF.decode_step(
            cfg, params, cache, batch["tokens"], rules)
    if bundle.kind == "serve":
        return lambda params, batch: RS.fm_scores(cfg, params, batch["ids"],
                                                  rules)
    if bundle.kind == "retrieval":
        return lambda params, batch: RS.retrieval_scores(
            cfg, params, batch["ids"], batch["cand"], batch["cand_bias"],
            rules)
    raise ValueError(bundle.kind)
