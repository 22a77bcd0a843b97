"""Rank side of ``tests/test_torch_mesh_lm.py``: the LM over a process mesh,
run on every rank of a 4-rank gloo mesh laid out as a (2, 2) ('data',
'model') grid.

Imported by the spawned ranks (torch and ``repro_torch`` only, no JAX);
the reference's parameters arrive as the port's state dicts (CPU
tensors, ``transformer.params_from_reference``).  :func:`run_cases`
returns, on rank 0, a dict of the meshed results, every gradient and
parameter gathered whole.
"""
import os

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import common as TCOM
from repro_torch.configs import get_config
from repro_torch.distributed import fault_tolerance as FT
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch import mesh as TM
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

GRID = ((2, 2), ("data", "model"))
S = 4
ARCHS = ["qwen3-14b", "minicpm3-4b", "mixtral-8x7b",
         "llama4-maverick-400b-a17b"]
BATCH, LEN = 4, 16
# sequence parallel: one dense and one MoE config; expert parallel:
# mixtral's 4 smoke experts over a TP axis of 2, also sequence parallel
SP_ARCHS = ["qwen3-14b", "mixtral-8x7b"]
EP_ARCH, EP_TP = "mixtral-8x7b", 2
# a batch the data axis does not divide: its rows whole on both data ranks
ODD_BATCH = 3
STEP_ARCH = "qwen3-14b"
SERVE_ARCHS = ["qwen3-14b", "minicpm3-4b"]
REF_SERVE_ARCH = "qwen3-14b"       # served by the reference's process too
DECODE_STEPS = 3
OPT = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
# the MoE case whose capacity binds: llama4-smoke (top-1, 4 experts) at
# 4 x 64 tokens, its router skewed to expert 0: one group of 256 tokens
# (C 128) drops its last 128, two groups of 128 (C 128) drop none
CAP_ARCH, CAP_BATCH, CAP_LEN = "llama4-maverick-400b-a17b", 4, 64


def smoke(arch: str):
    return get_config(arch).smoke


def tokens(arch: str, batch: int = BATCH, length: int = LEN) -> np.ndarray:
    cfg = smoke(arch)
    return np.random.default_rng(7).integers(
        0, cfg.vocab, (batch, length)).astype(np.int32)


def shardings(cfg, rules, tp_size: int = 16) -> dict:
    """{parameter name: Placement} from the reference's table at
    ``tp_size`` (it decides expert parallel or TP within each expert)."""
    return TCOM.param_shardings(rules, T.Transformer(cfg, device="meta"),
                                T.param_logical_axes(cfg, tp_size))


def model_on(cfg, sd: dict, rules, tp_size: int = 16) -> T.Transformer:
    """The model from the whole state dict ``sd``: whole without a mesh,
    this rank's blocks over one."""
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(sd)
    if rules.mesh is not None:
        FT.reshard_state(model, shardings(cfg, rules, tp_size))
    return model


def whole(model: T.Transformer, values: dict) -> dict:
    """{name: numpy} of per-parameter block ``values``, gathered whole in
    one all-gather of every rank's blocks (a rank's block of each split
    dim placed by its grid coordinates)."""
    pl = model.placements
    if not pl:
        return {k: v.numpy() for k, v in values.items()}
    mesh = next(iter(pl.values())).mesh
    names = sorted(values)
    every = mesh.over(tuple(mesh.axis_names)).all_gather(torch.cat(
        [values[k].detach().float().reshape(-1) for k in names]))
    out, at = {}, 0
    for k in names:
        block = tuple(values[k].shape)
        n = values[k].numel()
        full = None
        for q in range(mesh.size):
            who = TM.Mesh(None, q, mesh.size, mesh.device, mesh.backend,
                          shape=mesh.shape, axis_names=mesh.axis_names)
            index = [slice(None)] * len(block)
            size = list(block)
            for dim, e in enumerate(pl[k].entries):
                if e is not None:
                    i, count = who.coord(e)
                    index[dim] = slice(i * block[dim], (i + 1) * block[dim])
                    size[dim] = block[dim] * count
            if full is None:
                full = torch.empty(size)
            full[tuple(index)] = every[q, at:at + n].reshape(block)
        out[k] = full.to(values[k].dtype).numpy()
        at += n
    return out


def loss_grads(cfg, sd: dict, toks, rules, tp_size: int = 16) -> dict:
    """{'loss', 'nll', 'aux', 'grads'} of one loss: over a mesh each
    rank's shares summed as the train step sums them
    (``configs.common.reduce_grads``), then gathered whole."""
    model = model_on(cfg, sd, rules, tp_size)
    total, m = T.loss_fn(cfg, model, {"tokens": torch.as_tensor(toks)},
                         rules)
    total.backward()
    named = dict(model.named_parameters())
    if rules.mesh is not None:
        TCOM.reduce_grads(named, model.placements, rules.mesh)
    return {"loss": float(total.detach()), "nll": float(m["loss"].detach()),
            "aux": float(m["aux"].detach()),
            "grads": whole(model, {k: p.grad for k, p in named.items()})}


def train_step(cfg, sd: dict, toks, rules):
    """One ``make_step`` train step from ``sd``: (state, metrics)."""
    model = model_on(cfg, sd, rules)
    ac = TCOM.ArchConfig(cfg.name, "lm", cfg, cfg)
    step = TCOM.make_step(ac, TCOM.SpecBundle("train", cfg, {}, {}), rules,
                          OPT)
    return step(adamw.init_state(model), {"tokens": torch.as_tensor(toks)})


def decode_tokens(arch: str) -> np.ndarray:
    """The tokens fed to the DECODE_STEPS decode steps, (steps, B, 1)."""
    return np.random.default_rng(8).integers(
        0, smoke(arch).vocab, (DECODE_STEPS, BATCH, 1)).astype(np.int32)


def serve(cfg, sd: dict, toks, steps, rules) -> np.ndarray:
    """Prefill, then a decode step per row of ``steps``: the logits (1 +
    steps, B, vocab) on every rank."""
    model = model_on(cfg, sd, rules)
    logits, cache = T.prefill(cfg, model, torch.as_tensor(toks), rules)
    cache = T.grow_cache(cache, toks.shape[1] + len(steps))
    out = [logits]
    for t in steps:
        logits, cache = T.decode_step(cfg, model, cache, torch.as_tensor(t),
                                      rules)
        out.append(logits)
    return torch.stack(out).numpy()


def run_cases(mesh, sds: dict, work: str) -> dict:
    """Every case on this rank of the (2, 2) grid; rank 0 returns the
    results.  ``sds``: the reference's parameters as state dicts, by arch
    (and 'cap' for the capacity case)."""
    rules = make_rules(mesh)
    out = {}
    for arch in ARCHS:
        mesh.reset_counts()
        out[arch] = loss_grads(smoke(arch), sds[arch], tokens(arch), rules)
        out[f"{arch}/collectives"] = mesh.counts()
    sp = make_rules(mesh, seq_parallel=True)
    for arch in SP_ARCHS:
        mesh.reset_counts()
        out[f"sp/{arch}"] = loss_grads(smoke(arch), sds[arch], tokens(arch),
                                       sp)
        out[f"sp/{arch}/collectives"] = mesh.counts()
    out["ep"] = loss_grads(smoke(EP_ARCH), sds[EP_ARCH], tokens(EP_ARCH),
                           rules, EP_TP)
    # expert parallel on sequence-split tokens: the all-to-all exchange
    mesh.reset_counts()
    out["sp/ep"] = loss_grads(smoke(EP_ARCH), sds[EP_ARCH], tokens(EP_ARCH),
                              sp, EP_TP)
    out["sp/ep/collectives"] = mesh.counts()
    # ... at a batch the data axis does not divide (one dispatch group; the
    # aux loss's sums over the model ranks only)
    out["sp/ep/odd"] = loss_grads(smoke(EP_ARCH), sds[EP_ARCH],
                                  tokens(EP_ARCH, ODD_BATCH), sp, EP_TP)
    out["ep/entries"] = shardings(smoke(EP_ARCH), rules, EP_TP)[
        "layers.0.moe.w1"].entries

    # capacity bound: the (2, 2) grid's two data shards are two groups
    cfg = smoke(CAP_ARCH)
    out["cap"] = loss_grads(cfg, sds["cap"],
                            tokens(CAP_ARCH, CAP_BATCH, CAP_LEN), rules)

    # one AdamW step, its checkpoint, and the state's reshard round trip
    cfg = smoke(STEP_ARCH)
    mesh.reset_counts()
    state, metrics = train_step(cfg, sds[STEP_ARCH], tokens(STEP_ARCH),
                                rules)
    out["step/collectives"] = mesh.counts()
    model = state.params
    out["step/loss"] = float(metrics["loss"])
    out["step/params"] = whole(model, {k: p.detach() for k, p in
                                       model.named_parameters()})
    sh = TCOM.state_shardings(model.placements)
    ckpt.save(os.path.join(work, "lm_ckpt"), 1, state, shardings=sh)
    blocks = {k: p.detach().clone() for k, p in model.named_parameters()}
    FT.reshard_state(state, None, old=sh)            # gathered whole
    out["step/whole_shapes"] = all(
        tuple(p.shape) == tuple(out["step/params"][k].shape)
        for k, p in model.named_parameters())
    FT.reshard_state(state, sh)                       # and back to blocks
    out["step/reshard_same"] = all(
        torch.equal(p, blocks[k]) for k, p in model.named_parameters())
    out["step/placements_kept"] = model.placements == sh.params
    # the 4-rank checkpoint restored onto a (1, 2) mesh of ranks 0 and 1
    pair = TM.make_mesh((1, 2), ("data", "model"), device="cpu",
                        ranks=[0, 1])
    if pair is not None:
        prules = make_rules(pair)
        target = adamw.init_state(T.Transformer(cfg, device="meta",
                                                shardings=shardings(
                                                    cfg, prules)))
        back = ckpt.restore(os.path.join(work, "lm_ckpt"), 1, target,
                            device="cpu",
                            shardings=TCOM.state_shardings(
                                target.params.placements))
        got = whole(back.params, {k: p.detach() for k, p in
                                  back.params.named_parameters()})
        if pair.rank == 0:
            out["restored2"] = got

    # the serving grid, (1, 4): one q head a rank, and kv blocks of half a
    # head, so each rank gathers the kv weights and takes the head it reads
    line = TM.make_mesh((1, S), ("data", "model"), device="cpu")
    rules14 = make_rules(line)
    out["grid14"] = loss_grads(smoke(STEP_ARCH), sds[STEP_ARCH],
                               tokens(STEP_ARCH), rules14)
    out["grid14/serve"] = serve(smoke(STEP_ARCH), sds[STEP_ARCH],
                                tokens(STEP_ARCH), decode_tokens(STEP_ARCH),
                                rules14)

    # meshed prefill and decode
    for arch in SERVE_ARCHS:
        mesh.reset_counts()
        out[f"serve/{arch}"] = serve(smoke(arch), sds[arch], tokens(arch),
                                     decode_tokens(arch), rules)
        out[f"serve/{arch}/collectives"] = mesh.counts()

    # the train CLI under this 4-rank world, as a (2, 2) grid
    from repro_torch.launch import train
    out["cli"] = train.main(["--arch", "qwen3-14b", "--smoke", "--steps",
                             "2", "--device", "cpu", "--grid", "2,2",
                             "--log-every", "1", "--ckpt-dir",
                             os.path.join(work, "cli")])
    return out if mesh.rank == 0 else None


def restored_on_one_device(work: str) -> dict:
    """The 4-rank checkpoint of the AdamW step restored onto one device:
    {parameter name: numpy}."""
    cfg = smoke(STEP_ARCH)
    target = adamw.init_state(T.Transformer(cfg, device="cpu"))
    back = ckpt.restore(os.path.join(work, "lm_ckpt"), 1, target)
    return {k: p.detach().numpy() for k, p in back.params.named_parameters()}
