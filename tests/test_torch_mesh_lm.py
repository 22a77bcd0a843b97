"""Port parity for the LM over a process mesh: 4 gloo ranks on the CPU laid
out as a (2, 2) ('data', 'model') grid (``tests/_torch_mesh_lm_cases.py``
``run_cases``, one pool for the module), held to the reference computed
in this process on the same parameters (the port's draws, carried to the
reference's tree) and tokens, and, where the
MoE capacity binds, to the reference's own meshed run
and for prefill and decode, to the reference's runs in a process of
its own (``tests/_ref_lm_mesh_runs.py``), all running beside the pool.

* The four smoke LMs (GQA with qk-norm, MLA, MoE top-2 with a window, MoE
  top-1 every second layer): the meshed loss within 1e-5 relative and
  every gradient (each rank's shares summed as the train step sums them,
  gathered whole) within 1e-4 of the largest, against the reference's
  meshless ``value_and_grad``; the same with sequence parallelism (one
  dense, one MoE) and with mixtral's experts split over ``model``
  (``tp_size`` 2: the expert-parallel placement), also sequence parallel
  (its tokens sent to their experts' ranks in all-to-alls), there also at
  a batch the data axis does not divide.
* A capacity that binds per data shard: one group drops what two do not,
  and the port equals the reference's (2, 2) mesh.
* One AdamW step's parameters; its 4-rank checkpoint restored on 2 ranks
  and on one device; the state gathered whole and split again.
* Meshed prefill and 3 decode steps: the logits within 1e-5 (MLA against
  the port's one-device run); and on the serving grid (1, 4), where the
  kv heads do not split over the ranks.
* ``launch.train --grid 2,2`` for an LM under the pool.
* The AdamW step traced on meta tensors as rank 0 of a dry (2, 2) mesh
  (``launch.dryrun``): the pool's rank-0 collectives, calls and bytes.
"""
import dataclasses
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import transformer as RT
from repro.optim import adamw as RA
from repro_torch.configs import common as TCOM
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as TM
from repro_torch.models import transformer as T

import _torch_mesh_cases as MC
import _torch_mesh_lm_cases as C
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
LOSS_TOL, GRAD_TOL, LOGIT_TOL = 1e-5, 1e-4, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# the reference compiled with LLVM's cheaper passes: it runs once, beside
# the pool, so its compile time is the module's
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def _ref_cfg(arch: str):
    # remat changes no value; the meshless reference compiles faster
    # without it
    return dataclasses.replace(ref_config(arch).smoke, remat=False)


def _ref_loss(arch: str, params, toks) -> dict:
    cfg = _ref_cfg(arch)
    (loss, m), grads = jax.jit(jax.value_and_grad(
        lambda p, t: RT.loss_fn(cfg, p, {"tokens": t}), has_aux=True),
        compiler_options=FAST)(params, jnp.asarray(toks))
    return {"loss": float(loss), "nll": float(m["loss"]),
            "aux": float(m["aux"]), "grads": _np(grads)}


def _skewed(arch: str, tree: dict) -> dict:
    """The reference's tree with every embedding row moved toward one
    direction u and each MoE router's expert-0 column along u: nearly
    every token routes to expert 0."""
    d = ref_config(arch).smoke.d_model
    u = np.random.default_rng(11).standard_normal(d).astype(np.float32)
    tree = jax.tree.map(np.array, tree)
    tree["embed"] = (tree["embed"] * 0.1 + u).astype(tree["embed"].dtype)
    for sub in tree["layers"].values():
        if "moe" in sub:
            sub["moe"]["router"][:, :, 0] = u * 4.0 / np.sqrt(d)
    return tree


def _flat(tree, prefix="") -> dict:
    if not isinstance(tree, dict):
        return {prefix[1:]: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _unflat(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return tree


def _ref_tree(cfg, sd: dict) -> dict:
    """The port's state dict as the reference's numpy tree (layer i is
    group i // period of ``sub{i % period}``): the inverse of
    ``params_from_reference``."""
    P = cfg.moe_period
    out = {k: sd[k].numpy() for k in ("embed", "final_norm", "lm_head")
           if k in sd}
    layers: dict = {}
    for i in range(cfg.n_layers):
        sub = layers.setdefault(f"sub{i % P}", {})
        pre = f"layers.{i}."
        for k, v in sd.items():
            if k.startswith(pre):
                *part, name = k[len(pre):].split(".")
                node = sub
                for p in part:
                    node = node.setdefault(p, {})
                node.setdefault(name, []).append(v.numpy())
    out["layers"] = jax.tree.map(np.stack, layers,
                                 is_leaf=lambda x: isinstance(x, list))
    return out


def _named(arch: str, tree) -> dict:
    """The reference's tree (parameters or gradients) by the port's names."""
    return {k: v.numpy() for k, v in
            T.params_from_reference(C.smoke(arch), _np(tree)).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port: rank 0's results, ref: the reference's, the work directory).
    The pool and the reference's process run while this process computes
    the reference's meshless losses.  The parameters
    are the port's draws, carried to both sides."""
    work = str(tmp_path_factory.mktemp("mesh_lm"))
    trees = {a: _ref_tree(C.smoke(a), T.Transformer(
        C.smoke(a), seed=0, device="cpu").state_dict()) for a in C.ARCHS}
    trees["cap"] = _skewed(C.CAP_ARCH, trees[C.CAP_ARCH])
    cap_toks = C.tokens(C.CAP_ARCH, C.CAP_BATCH, C.CAP_LEN)
    sds = {a: T.params_from_reference(
        C.smoke(C.CAP_ARCH if a == "cap" else a), t) for a, t in trees.items()}
    # the reference's meshed capacity case and its meshless prefill and
    # decode, in one process of 4 host devices
    cases = {"cap": (C.CAP_ARCH, cap_toks, None),
             C.REF_SERVE_ARCH: (C.REF_SERVE_ARCH, C.tokens(C.REF_SERVE_ARCH),
                                C.decode_tokens(C.REF_SERVE_ARCH))}
    feed = {}
    for tag, (arch, toks, steps) in cases.items():
        feed.update({f"{tag}/arch": arch, f"{tag}/tokens": toks})
        if steps is not None:
            feed[f"{tag}/steps"] = steps
        feed.update({f"{tag}/p/{k}": v for k, v in _flat(trees[tag]).items()})
    np.savez(os.path.join(work, "ref_in.npz"), **feed)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_ref_lm_mesh_runs.py"),
         os.path.join(work, "ref_in.npz"), os.path.join(work, "ref_out.npz")],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    ref = {}
    try:
        with ThreadPoolExecutor(2 + len(C.ARCHS)) as pool, \
                MC.torch_threads(1):
            four = pool.submit(TM.spawn, C.run_cases, C.S, device="cpu",
                               init_file=os.path.join(work, "init4"),
                               grid=C.GRID, args=(sds, work), timeout=300,
                               coll_timeout=MC.COLL_TIMEOUT)
            # XLA compiles the four losses side by side
            losses = {a: pool.submit(_ref_loss, a, trees[a], C.tokens(a))
                      for a in C.ARCHS}
            losses["odd"] = pool.submit(
                _ref_loss, C.EP_ARCH, trees[C.EP_ARCH],
                C.tokens(C.EP_ARCH, C.ODD_BATCH))
            # the port's one-device runs (held to the reference's by
            # tests/test_torch_models.py and tests/test_torch_train.py;
            # remat changes no value), while XLA compiles: the capacity
            # case as one dispatch group, and the serving of the configs
            # the reference's process does not run
            ref["cap/one_group"] = C.loss_grads(
                dataclasses.replace(C.smoke(C.CAP_ARCH), remat=False),
                sds["cap"], cap_toks, make_rules(None))
            for a in C.SERVE_ARCHS:
                if a != C.REF_SERVE_ARCH:
                    ref[f"serve/{a}"] = C.serve(
                        C.smoke(a), sds[a], C.tokens(a), C.decode_tokens(a),
                        make_rules(None))
            # the AdamW step traced on meta as rank 0 of a dry grid
            ref["dry/step"] = D.dry_step(
                get_config(C.STEP_ARCH), TCOM.SpecBundle(
                    "train", C.smoke(C.STEP_ARCH), {"tokens": torch.empty(
                        (C.BATCH, C.LEN), dtype=torch.int32,
                        device="meta")}, {}),
                make_rules(TM.make_dry_mesh(*C.GRID)))["collectives"]
            # the AdamW step as soon as its gradients are in
            ref[C.STEP_ARCH] = losses[C.STEP_ARCH].result()
            opt = RA.AdamWConfig(lr=C.OPT.lr, warmup_steps=0,
                                 total_steps=C.OPT.total_steps)
            state = jax.jit(lambda s, g: RA.apply_update(opt, s, g),
                            compiler_options=FAST)(
                RA.init_state(jax.tree.map(jnp.asarray, trees[C.STEP_ARCH])),
                jax.tree.map(jnp.asarray, ref[C.STEP_ARCH]["grads"]))
            ref["step/params"] = _named(C.STEP_ARCH, state.params)
            ref.update({a: f.result() for a, f in losses.items()})
            port = four.result()[0]
    finally:
        log = proc.communicate(timeout=600)[0]
    assert proc.returncode == 0, log
    with np.load(os.path.join(work, "ref_out.npz")) as z:
        ref["cap/mesh"] = {k: float(z[f"cap/{k}"])
                           for k in ("loss", "nll", "aux")}
        ref["cap/mesh"]["grads"] = _unflat({k[6:]: z[k] for k in z.files
                                            if k.startswith("cap/g/")})
        a = C.REF_SERVE_ARCH
        ref[f"serve/{a}"] = z[f"{a}/logits"]
    ref["restored1"] = C.restored_on_one_device(work)
    return port, ref, work


def _close(got: float, want: float):
    assert abs(got - want) <= LOSS_TOL * max(1.0, abs(want)), (got, want)


def _grads_close(got: dict, want: dict, tol: float = GRAD_TOL):
    assert set(got) == set(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol * scale,
                                   err_msg=k)


def _same_loss(got: dict, want: dict, arch: str):
    for k in ("loss", "nll", "aux"):
        _close(got[k], want[k])
    _grads_close(got["grads"], _named(arch, want["grads"]))


@pytest.mark.parametrize("arch", C.ARCHS)
def test_meshed_lm_equals_reference(runs, arch):
    port, ref, _ = runs
    _same_loss(port[arch], ref[arch], arch)
    calls = port[f"{arch}/collectives"]["calls"]
    assert calls["all_gather"] > 0 and calls["all_reduce"] > 0


@pytest.mark.parametrize("arch", C.SP_ARCHS)
def test_sequence_parallel_equals_reference(runs, arch):
    """The residual stream split over ``model`` by its sequence: each
    region gathers it and reduce-scatters its output, so the meshed run
    makes more all-gathers than without, and gives the same values."""
    port, ref, _ = runs
    _same_loss(port[f"sp/{arch}"], ref[arch], arch)
    assert port[f"sp/{arch}/collectives"]["calls"]["all_gather"] > \
        port[f"{arch}/collectives"]["calls"]["all_gather"]


def test_expert_parallel_placement_equals_reference(runs):
    """mixtral's experts split over ``model``: tokens whole over it take a
    slice and a sum; sequence-split tokens travel to their experts' ranks
    in all-to-alls.  Both give the reference's values."""
    port, ref, _ = runs
    assert port["ep/entries"] == ("model", ("data",), None)
    _same_loss(port["ep"], ref[C.EP_ARCH], C.EP_ARCH)
    _same_loss(port["sp/ep"], ref[C.EP_ARCH], C.EP_ARCH)
    assert port["sp/ep/collectives"]["calls"]["all_to_all"] > 0
    assert port[f"sp/{C.EP_ARCH}/collectives"]["calls"]["all_to_all"] == 0


def test_expert_parallel_at_an_undivided_batch_equals_reference(runs):
    """Sequence-split tokens sent to their experts' ranks where the data
    axis does not divide the batch: both data ranks hold the same rows,
    one dispatch group, and the aux loss counts each token once."""
    port, ref, _ = runs
    _same_loss(port["sp/ep/odd"], ref["odd"], C.EP_ARCH)
    assert ref["odd"]["aux"] > 0


def test_capacity_binds_per_data_shard(runs):
    """Two data shards are two dispatch groups: one group (the port on one
    device) drops the last half of the tokens at expert 0's capacity and
    two groups drop none, so the losses differ; the port's (2, 2) run
    equals the reference's (2, 2) mesh."""
    port, ref, _ = runs
    one, two = ref["cap/one_group"], ref["cap/mesh"]
    assert abs(one["nll"] - two["nll"]) > 1e-3, (one["nll"], two["nll"])
    for k in ("loss", "nll", "aux"):
        _close(port["cap"][k], two[k])
    _grads_close(port["cap"]["grads"], _named(C.CAP_ARCH, two["grads"]))


def test_adamw_step_over_a_mesh(runs):
    port, ref, _ = runs
    _close(port["step/loss"], ref[C.STEP_ARCH]["nll"])
    want = ref["step/params"]
    assert set(port["step/params"]) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(
            port["step/params"][k], w, rtol=1e-4,
            atol=1e-4 * max(float(np.abs(w).max()), 1e-12), err_msg=k)


def test_dry_step_equals_the_pools_collectives(runs):
    """One AdamW step of the smoke LM traced on meta tensors as rank 0 of a
    dry (2, 2) mesh (``launch.dryrun``, in the fixture) makes the
    collectives, by kind, calls and bytes, that rank 0 of the pool made for
    the same step."""
    port, ref, _ = runs
    got = port["step/collectives"]
    assert got["collectives"] > 0
    assert {k: (c["count"], c["bytes"])
            for k, c in ref["dry/step"].items()} == \
        {k: (got["calls"][k], got["bytes"][k]) for k in got["calls"]}


def test_lm_checkpoint_restores_on_one_device_and_reshards(runs):
    """The 4-rank checkpoint of the AdamW step, its leaves split over
    ``data`` and ``model`` at once, restored onto a (1, 2) mesh of two of
    the ranks and onto one device; the state gathered whole and split
    again on the 4 ranks."""
    port, ref, _ = runs
    for got in (ref["restored1"], port["restored2"]):
        assert set(got) == set(port["step/params"])
        for k, v in port["step/params"].items():
            assert got[k].tobytes() == v.tobytes(), k
    assert port["step/whole_shapes"] and port["step/reshard_same"]
    assert port["step/placements_kept"]


@pytest.mark.parametrize("arch", C.SERVE_ARCHS)
def test_meshed_prefill_and_decode_equal_reference(runs, arch):
    """qwen3 (GQA) against the reference's meshless run; minicpm3 (MLA, the
    latent cache whole on each model rank) against the port's one-device
    run, itself held to the reference by tests/test_torch_models.py."""
    port, ref, _ = runs
    got, want = port[f"serve/{arch}"], ref[f"serve/{arch}"]
    assert got.shape == want.shape == (1 + C.DECODE_STEPS, C.BATCH,
                                       C.smoke(arch).vocab)
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_serving_grid_equals_reference(runs):
    """qwen3-smoke over a (1, 4) grid: a q head a rank, kv blocks of half
    a head gathered whole and the read head taken; loss, gradients,
    prefill and decode as the reference's."""
    port, ref, _ = runs
    _same_loss(port["grid14"], ref[C.STEP_ARCH], C.STEP_ARCH)
    np.testing.assert_allclose(port["grid14/serve"], ref["serve/qwen3-14b"],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_train_cli_over_a_grid(runs):
    port, _, _ = runs
    cli = port["cli"]
    assert [r["step"] for r in cli["logs"]] == [1, 2]
    assert cli["report"]["steps_run"] == 2
    assert all(np.isfinite(r["loss"]) for r in cli["logs"])


@pytest.mark.parametrize("grid,heads,kv", [((1, 4), 10, 2), ((2, 2), 20, 4)])
def test_qwen3_blocks_per_rank(grid, heads, kv):
    """qwen3-14b's placements over a grid, from the reference's table: each
    rank's q and kv heads, and its FSDP block of the embed dim."""
    cfg = get_config("qwen3-14b").model
    H, Kv, hd, d0 = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    shapes = {"layers.0.attn.wq": torch.empty(d0, H * hd, device="meta"),
              "layers.0.attn.wk": torch.empty(d0, Kv * hd, device="meta")}
    pax = {k: T.param_logical_axes(cfg)[k] for k in shapes}
    for r in range(int(np.prod(grid))):
        mesh = TM.Mesh(None, r, int(np.prod(grid)), torch.device("cpu"),
                       "gloo", shape=grid, axis_names=("data", "model"))
        sh = TCOM.param_shardings(make_rules(mesh), shapes, pax)
        d = cfg.d_model // grid[0]
        assert sh["layers.0.attn.wq"].block_shape(
            (cfg.d_model, cfg.n_heads * cfg.head_dim)) == (d, heads * 128)
        assert sh["layers.0.attn.wk"].block_shape(
            (cfg.d_model, cfg.n_kv_heads * cfg.head_dim)) == (d, kv * 128)


def test_lm_without_placements_over_a_mesh_raises():
    mesh = TM.Mesh(None, 0, 4, torch.device("cpu"), "gloo", shape=(2, 2),
                   axis_names=("data", "model"))
    cfg = C.smoke("qwen3-14b")
    model = T.Transformer(cfg, device="cpu")
    with pytest.raises(ValueError, match="placements"):
        T.loss_fn(cfg, model, {"tokens": torch.zeros(4, 8, dtype=torch.long)},
                  make_rules(mesh))
    ac = get_config("qwen3-14b")
    for kind in ("train", "prefill", "decode"):
        assert callable(TCOM.make_step(ac, TCOM.SpecBundle(kind, cfg, {}, {}),
                                       make_rules(mesh)))
