"""Rank side of ``tests/test_torch_mesh_train.py``: training over a process
mesh, run on every rank of a 4-rank gloo mesh laid out as a (2, 2) grid
(flat S 4, data 2), the elastic resume on a (2, 1) mesh of two of them.

Imported by the spawned ranks (torch and ``repro_torch`` only, no JAX);
the reference's parameters arrive as numpy arguments.  :func:`run_cases`
returns, on rank 0, a dict of the meshed results; the GNN and FM sizes are
the reference's own multi-device test's (``tests/_distributed_main.py``).
"""
import contextlib
import functools
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.configs import common as TCOM
from repro_torch.core.graph import uniform_random_graph
from repro_torch.data import synthetic
from repro_torch.distributed import fault_tolerance as FT
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch import mesh as TM
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.optim import adamw, compression

GRID = ((2, 2), ("data", "model"))
S = 4
# seconds a collective of the pool waits for a peer: the module passes in
# 20-30 s, so a stalled collective fails named long before spawn's 300 s
COLL_TIMEOUT = 120.0
# the reference's own sizes (tests/_distributed_main.py, GNN DGAS vs local)
ARCHS = {"gin": dict(n_layers=2, d_hidden=16),
         "gatedgcn": dict(n_layers=2, d_hidden=16),
         "dimenet": dict(n_layers=2, d_hidden=16, triplet_chunk=64),
         "equiformer_v2": dict(n_layers=1, d_hidden=8, l_max=2, m_max=2,
                               n_heads=2, edge_chunk=32)}
FM_CFG = dict(name="fm-test", n_fields=4, embed_dim=4, rows_per_field=16,
              use_dgas=True, dgas_cap_factor=10 ** 6)
FM_BATCH = 16
OVERFLOW_FACTOR = 1               # capacity ceil(64 / 4): drops
COMPRESS_SHAPES = {"a": (64,), "b": (3, 5)}
OPT = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10)
RESUME_ARCH = "gin"


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads set to ``n`` inside: a test process that
    computes its side beside a pool of ranks (and JAX's own threads) only
    spins against them with more."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@contextlib.contextmanager
def one_rank_mesh():
    """A (1, 1) ('data', 'model') mesh over a 1-rank gloo world on the CPU
    in this process."""
    init = tempfile.mktemp(prefix="repro_torch_mesh1_")
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=1, rank=0)
    try:
        yield TM.make_mesh((1, 1), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()
        if os.path.exists(init):
            os.unlink(init)


def gnn_cfg(arch: str, **over) -> G.GNNConfig:
    """The reference test's config: DGAS forced (threshold 1), exact
    capacity (no drops)."""
    kw = dict(name=arch, arch=arch, d_feat=8, n_classes=3, dgas_threshold=1,
              dgas_cap_factor=10 ** 6, **ARCHS[arch])
    kw.update(over)
    return G.GNNConfig(**kw)


@functools.lru_cache(maxsize=None)
def gnn_inputs(arch: str, n: int = 64) -> dict:
    """The reference test's batch: ``uniform_random_graph(n, 4, seed=9)``,
    edges and triplets padded to a multiple of 8 (src / kj -1, wigner the
    identity).  Built once per process (read, never written)."""
    g = uniform_random_graph(n, 4, seed=9, device="cpu")
    b = synthetic.gnn_batch(arch, g, 8, 3, l_max=2, seed=3)
    E = b["src"].shape[0]
    pad = -(-E // 8) * 8 - E
    for k in ("src", "dst"):
        b[k] = np.concatenate([b[k], np.full(pad, -1, np.int32)])
    if "wigner" in b:
        b["wigner"] = np.concatenate(
            [b["wigner"], np.tile(np.eye(9, dtype=np.float32), (pad, 1, 1))])
    if "triplet_kj" in b:
        T = b["triplet_kj"].shape[0]
        tp = -(-T // 8) * 8 - T
        b["triplet_kj"] = np.concatenate([b["triplet_kj"],
                                          np.full(tp, -1, np.int32)])
        b["triplet_ji"] = np.concatenate([b["triplet_ji"],
                                          np.zeros(tp, np.int32)])
        b["angle"] = np.concatenate([b["angle"], np.zeros(tp, np.float32)])
    return b


def fm_inputs():
    """ids (16, 4) in [0, 64) and labels, as the reference test draws them
    (its rng's state at that point is not replayed: any ids will do)."""
    rng = np.random.default_rng(4)
    return (rng.integers(0, 64, (FM_BATCH, 4)).astype(np.int32),
            rng.integers(0, 2, FM_BATCH).astype(np.float32))


def retrieval_inputs():
    """Candidate vectors and biases (a count the flat size divides)."""
    rng = np.random.default_rng(6)
    return (torch.from_numpy(rng.standard_normal((40, 4)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(40).astype(np.float32)))


def compress_inputs(rank: int) -> dict:
    rng = np.random.default_rng(10 + rank)
    return {k: (rng.standard_normal(s) * 0.01).astype(np.float32)
            for k, s in COMPRESS_SHAPES.items()}


def _replicated(rules, params) -> dict:
    named = adamw.named_params(params)
    return TCOM.param_shardings(rules, params,
                                {k: (None,) * p.dim() for k, p in
                                 named.items()})


def gnn_loss_grads(cfg, params_np, batch, rules) -> tuple:
    """(loss, {name: gradient}) of one meshed (or local) loss: each rank's
    share's gradient, summed over the ranks as the train step sums it."""
    params = G.params_from_reference(cfg, params_np, device="cpu")
    named = adamw.named_params(params)
    for p in named.values():
        p.requires_grad_(True)
    loss, _ = G.loss_fn(cfg, params, batch, rules)
    loss.backward()
    if rules.mesh is not None:
        TCOM.reduce_grads(named, _replicated(rules, params), rules.mesh)
    return float(loss.detach()), {k: p.grad.numpy() for k, p in named.items()}


def fm_loss_grads(cfg, params_np, ids, labels, rules) -> dict:
    """FM's scores (this rank's rows), loss and whole gradients."""
    params = {k: torch.from_numpy(np.array(v)) for k, v in params_np.items()}
    shardings = TCOM.param_shardings(rules, params,
                                     {"table": ("rows", None), "w0": ()})
    if rules.mesh is not None:
        params = FT.reshard_state(params, shardings)
    for p in params.values():
        p.requires_grad_(True)
    scores = R.fm_scores(cfg, params, ids, rules)
    loss, _ = R.loss_fn(cfg, params, {"ids": ids, "labels": labels}, rules)
    loss.backward()
    out = {"scores": scores.detach().numpy(), "loss": float(loss.detach())}
    if rules.mesh is not None:
        TCOM.reduce_grads(params, shardings, rules.mesh)
        out["rows"] = R.score_rows(cfg, rules, ids.shape[0]).block(
            torch.arange(ids.shape[0])).numpy()
        out["grads"] = {k: shardings[k].whole(p.grad).numpy()
                        for k, p in params.items()}
    else:
        out["grads"] = {k: p.grad.numpy() for k, p in params.items()}
    return out


def gnn_state(cfg, params_np, device="cpu"):
    params = G.params_from_reference(cfg, params_np, device=device)
    return adamw.init_state(params)


def train_steps(cfg, params_np, batch, rules, ckpt_dir, steps, *,
                fail_at=None, state=None):
    """run_training over one repeated batch, a checkpoint every step, from
    ``ckpt_dir`` (resuming from its newest checkpoint); the losses of the
    steps it ran, by step."""
    step = TCOM.make_step(_gnn_arch(cfg), TCOM.SpecBundle("train", cfg, {},
                                                           {}), rules, OPT)
    if state is None:
        state = gnn_state(cfg, params_np)
    shard = None
    if rules.mesh is not None:
        shard = TCOM.state_shardings(_replicated(rules, state.params))
    losses = {}

    def batches():
        while True:
            yield batch

    def fail(i):
        if fail_at is not None and i == fail_at and not losses.get("failed"):
            losses["failed"] = True
            raise FT.SimulatedFailure(f"injected at step {i + 1}")

    def on_metrics(i, m):
        losses[i] = float(m["loss"])
    state, report = FT.run_training(
        step, state, batches(), ckpt.CheckpointManager(ckpt_dir, every=1,
                                                       keep=5), steps,
        FT.FTConfig(ckpt_every=1), fail_injector=fail,
        on_metrics=on_metrics, shardings=shard)
    losses.pop("failed", None)
    return losses, report["restarts"]


def _gnn_arch(cfg):
    from repro_torch.configs.common import ArchConfig
    return ArchConfig(name=cfg.name, family="gnn", model=cfg, smoke=cfg)


def run_cases(mesh, ref: dict, work: str) -> dict:
    """Every case on this rank of the (2, 2) grid; rank 0 returns the
    results.  ``ref``: the reference's parameters (numpy) by case."""
    rules = make_rules(mesh)
    world = mesh.over(rules.flat)
    rank = world.rank
    out = {}

    def keep(name, x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
        y = world.gather(torch.as_tensor(np.atleast_1d(np.asarray(x))))
        if y is not None:
            out[name] = y.numpy()

    # the four GNNs, DGAS forced, exact capacity
    for arch in ARCHS:
        mesh.reset_counts()
        loss, grads = gnn_loss_grads(gnn_cfg(arch), ref[f"gnn/{arch}"],
                                     gnn_inputs(arch), rules)
        out[f"gnn/{arch}/loss"], out[f"gnn/{arch}/grads"] = loss, grads
        keep(f"gnn/{arch}/dropped", np.int64(mesh.dropped()))
        keep(f"gnn/{arch}/a2a", np.int64(mesh.calls["all_to_all"]))
        # the same step handed this rank's block, built directly (NaN
        # where the global form has it: equiformer's gradients at these
        # inputs are NaN in places, the reference's too)
        block = G.local_batch(gnn_cfg(arch), gnn_inputs(arch), rules)
        loss_b, grads_b = gnn_loss_grads(gnn_cfg(arch), ref[f"gnn/{arch}"],
                                         block, rules)
        keep(f"gnn/{arch}/rank_batch_same", np.int64(
            loss_b == loss and all(np.array_equal(grads_b[k], grads[k],
                                                  equal_nan=True)
                                   for k in grads)))
    # below the threshold (the all-gather path), and 66 nodes, which the
    # flat size does not divide (the whole-table path)
    loss, grads = gnn_loss_grads(gnn_cfg("gin", dgas_threshold=10 ** 12),
                                 ref["gnn/gin"], gnn_inputs("gin"), rules)
    out["gnn/gin_below/loss"], out["gnn/gin_below/grads"] = loss, grads
    loss, grads = gnn_loss_grads(gnn_cfg("gin"), ref["gnn/gin"],
                                 gnn_inputs("gin", 66), rules)
    out["gnn/gin_whole/loss"], out["gnn/gin_whole/grads"] = loss, grads

    # an overflowing capacity: x's rows at this rank's block of src
    cfg = gnn_cfg("gin", dgas_cap_factor=OVERFLOW_FACTOR)
    b = gnn_inputs("gin")
    x, src = torch.from_numpy(b["x"]), torch.from_numpy(b["src"])
    per, E = 64 // S, src.shape[0] // S
    mesh.reset_counts()
    rows = G.gather_nodes(cfg, x[rank * per:(rank + 1) * per],
                          src[rank * E:(rank + 1) * E], rules, n=64)
    keep("overflow/rows", rows)
    keep("overflow/dropped", np.int64(mesh.dropped()))

    # FM, DGAS lookup, and retrieval over candidates sharded by rows
    ids, labels = fm_inputs()
    fm = fm_loss_grads(R.FMConfig(**FM_CFG), ref["fm"], ids, labels, rules)
    keep("fm/scores", fm["scores"])
    keep("fm/rows", fm["rows"])
    out["fm/loss"], out["fm/grads"] = fm["loss"], fm["grads"]
    cand, bias = retrieval_inputs()
    fparams = {k: torch.from_numpy(np.array(v)) for k, v in ref["fm"].items()}
    fparams = FT.reshard_state(fparams, TCOM.param_shardings(
        rules, fparams, {"table": ("rows", None), "w0": ()}))
    with torch.no_grad():
        keep("fm/retrieval", R.retrieval_scores(
            R.FMConfig(**FM_CFG), fparams, ids[:1], cand, bias, rules))

    # compression over the 4 ranks
    grads = {k: torch.from_numpy(v) for k, v in
             compress_inputs(rank).items()}
    mesh.reset_counts()
    f32 = {k: world.all_reduce(v, "sum") for k, v in grads.items()}
    b_f32 = world.bytes["all_reduce"]
    mesh.reset_counts()
    bf = compression.psum_bf16(grads, world)
    b_bf16 = world.bytes["all_reduce"]
    mesh.reset_counts()
    ef0 = compression.init_ef_state(grads)
    s1, ef1 = compression.psum_int8_ef(grads, ef0, world)
    b_int8 = world.bytes["all_gather"]
    s2, ef2 = compression.psum_int8_ef(grads, ef1, world)
    # the reference's own check: the same gradient on every rank
    same = {k: torch.from_numpy(v) for k, v in compress_inputs(0).items()}
    same_bf16 = compression.psum_bf16(same, world)
    same_int8, _ = compression.psum_int8_ef(same, ef0, world)
    for k in COMPRESS_SHAPES:
        keep(f"compress/{k}/ef1", ef1[k])
        keep(f"compress/{k}/ef2", ef2[k])
        out[f"compress/{k}/f32"] = f32[k].numpy()
        out[f"compress/{k}/bf16"] = bf[k].numpy()
        out[f"compress/{k}/int8"] = s1[k].numpy()
        out[f"compress/{k}/int8_2"] = s2[k].numpy()
        out[f"compress/{k}/same_bf16"] = same_bf16[k].numpy()
        out[f"compress/{k}/same_int8"] = same_int8[k].numpy()
    out["compress/bytes"] = (b_f32, b_bf16, b_int8)

    # parameter shardings and a reshard round trip of FM's parameters
    fcfg = R.FMConfig(**FM_CFG)
    whole = {k: torch.from_numpy(np.array(v)) for k, v in ref["fm"].items()}
    sh = TCOM.param_shardings(rules, whole, {"table": ("rows", None),
                                             "w0": ()})
    out["shardings"] = {k: pl.entries for k, pl in sh.items()}
    blocks = FT.reshard_state(whole, sh)
    keep("reshard/table", blocks["table"])
    back = FT.reshard_state(blocks, None, old=sh)
    out["reshard/back_equal"] = all(torch.equal(back[k], whole[k])
                                    for k in whole)

    # a sharded checkpoint of an FM state, after one step
    state = adamw.init_state(blocks)
    step = TCOM.make_step(TCOM.ArchConfig("fm-test", "recsys", fcfg, fcfg),
                          TCOM.SpecBundle("train", fcfg, {}, {}), rules, OPT)
    state, _ = step(state, {"ids": ids, "labels": labels})
    ckpt.save(os.path.join(work, "fm_ckpt"), 1, state,
              shardings=TCOM.state_shardings(sh))
    out["fm_step/table"] = sh["table"].whole(state.params["table"]).numpy()
    back = ckpt.restore(os.path.join(work, "fm_ckpt"), 1, state,
                        shardings=TCOM.state_shardings(sh))
    out["fm_ckpt/same"] = all(
        torch.equal(a, b) for a, b in zip(
            adamw.named_params(back.params).values(),
            adamw.named_params(state.params).values()))

    # 2 steps with a checkpoint each and a failure injected on every rank
    # at step 2
    losses, restarts = train_steps(
        gnn_cfg(RESUME_ARCH), ref[f"gnn/{RESUME_ARCH}"],
        gnn_inputs(RESUME_ARCH), rules, os.path.join(work, "resume"), 2,
        fail_at=1)
    out["resume/losses"], out["resume/restarts"] = losses, restarts
    # the elastic resume from its step-1 checkpoint on a (2, 1) mesh of
    # ranks 0 and 1 (the test process resumes it on one device), and a
    # (2, 1) mesh over ranks 1 and 3.  Every rank builds both meshes'
    # groups together first (``new_group`` waits for every rank of the
    # world), then ranks 0 and 1 resume while the others go on.
    if mesh.rank == 0:
        for d in ("resume2", "resume1"):
            shutil.copytree(os.path.join(work, "resume", "step_00000001"),
                            os.path.join(work, d, "step_00000001"))
    mesh.barrier()
    pair = TM.make_mesh((2, 1), ("data", "model"), device="cpu", ranks=[0, 1])
    sub = TM.make_mesh((2, 1), ("data", "model"), device="cpu", ranks=[1, 3])
    if pair is not None:
        two = run_resume(pair, ref, work)
        if two is not None:
            out["resume2/losses"], out["fm_restored2"] = two["losses"], \
                two["fm"]
    got = [-1.0, -1.0]
    if sub is not None:
        flat = sub.over(("data", "model"))
        got = [float(flat.all_reduce(torch.tensor([float(rank)]))[0]),
               float(flat.rank)]
    keep("submesh", np.array(got))

    # the train CLI under this 4-rank world
    from repro_torch.launch import train
    out["cli"] = train.main(["--arch", "gin-tu", "--smoke", "--steps", "2",
                             "--device", "cpu", "--gnn-nodes", "64",
                             "--log-every", "1", "--ckpt-dir",
                             os.path.join(work, "cli")])
    return out if rank == 0 else None


def fm_restored(rules, work: str) -> dict:
    """The 4-rank FM checkpoint restored onto ``rules``' mesh (or one
    device), gathered whole: {parameter name: numpy}."""
    fcfg = R.FMConfig(**FM_CFG)
    whole = R.init_params(fcfg, 1, device="cpu")
    sh = TCOM.param_shardings(rules, whole, {"table": ("rows", None),
                                             "w0": ()})
    target = adamw.init_state(whole if rules.mesh is None
                              else FT.reshard_state(whole, sh))
    back = ckpt.restore(os.path.join(work, "fm_ckpt"), 1, target,
                        shardings=None if rules.mesh is None
                        else TCOM.state_shardings(sh))
    return {k: (p if sh[k] is None else sh[k].whole(p)).detach().numpy()
            for k, p in back.params.items()}


def run_resume(mesh, ref: dict, work: str) -> dict:
    """On a (2, 1) mesh: restore the 4-rank run's step-1 GNN checkpoint
    and run step 2; restore its sharded FM checkpoint onto this mesh's
    blocks."""
    rules = make_rules(mesh)
    cfg = gnn_cfg(RESUME_ARCH)
    losses, _ = train_steps(cfg, ref[f"gnn/{RESUME_ARCH}"],
                            gnn_inputs(RESUME_ARCH), rules,
                            os.path.join(work, "resume2"), 2)
    fm = fm_restored(rules, work)
    return {"losses": losses, "fm": fm} if mesh.rank == 0 else None
