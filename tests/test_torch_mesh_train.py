"""Port parity for training over a process mesh: 4 gloo ranks on the CPU
laid out as a (2, 2) grid (``tests/_torch_mesh_cases.py`` ``run_cases``,
one pool for the module; flat S 4, data 2; the elastic resume on a (2, 1)
mesh of two of its ranks), held to the live reference computed in this
process on the port's parameter draws.

* ``make_rules(mesh)``'s ``spec`` / ``dp_size`` and ``input_sharding``'s
  entries against the reference's rules on a stand-in mesh (its
  ``NamedSharding`` patched to hand back the spec: the entries compare,
  not the objects).
* The four GNNs at the reference's own multi-device test sizes, DGAS
  forced (threshold 1, exact capacity): the meshed loss and every
  gradient (each rank's share's, summed over the ranks) against the
  reference's meshless ``jax.value_and_grad`` on the same parameters and
  against the port's local path (loss 1e-5 relative, gradients 1e-5 of
  the largest); the same below the threshold (the all-gather path) and
  at 66 nodes, which the flat size does not divide (whole tables).
* An overflowing capacity: the drop count is what the capacity rule
  gives from the edge blocks, and the dropped rows read 0.
* FM's meshed DGAS scores and gradients, and retrieval over candidates
  sharded by rows, against the reference's meshless ones;
  ``param_shardings`` and ``reshard_state`` round trips; a sharded FM
  checkpoint that the reference's ``restore`` reads and that restores
  onto 2 ranks' blocks and onto one device.
* Compression: ``_quant_int8`` bit-equal to the reference's;
  ``psum_int8_ef``'s sums and error-feedback state bit-equal to the
  reference's quantization of each rank's input summed in int32, twice
  (the carried residual); ``psum_bf16`` within the reference's own
  tolerance; the all-reduce bytes halved and quartered.
* The meshed GNN step handed each rank's block (``gnn.local_batch``):
  the same loss and summed gradients, bit for bit, on every rank.
* The 4 -> 2 -> 1 rank resume from a 4-rank checkpoint, a failure
  injected on every rank, and ``launch.train.main`` under the 4-rank
  world.
"""
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as RCK
from repro.distributed import sharding as RSH
from repro.models import gnn as RG
from repro.models import recsys as RR
from repro.optim import adamw as RA
from repro.optim import compression as RCMP
from repro_torch.configs import common as TCOM
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch import mesh as TM
from repro_torch.models import gnn as TG
from repro_torch.models import recsys as TR
from repro_torch.optim import adamw, compression

import _torch_mesh_cases as C

TOL = 1e-5
# the reference compiled with LLVM's cheaper passes: it runs once, beside
# the pool, so its compile time is the module's
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_cfg(arch: str, **over):
    kw = dict(name=arch, arch=arch, d_feat=8, n_classes=3, dgas_threshold=1,
              dgas_cap_factor=10 ** 6, **C.ARCHS[arch])
    kw.update(over)
    return RG.GNNConfig(**kw)


def _ref_gnn(arch: str, params) -> tuple:
    """(loss, gradients by the port's names) of the meshless reference on
    the cases' inputs."""
    cfg = _ref_cfg(arch)
    batch = {k: jnp.asarray(v) for k, v in C.gnn_inputs(arch).items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: RG.loss_fn(cfg, p, b)[0]),
        compiler_options=FAST)(params, batch)
    named = adamw.named_params(TG.params_from_reference(
        C.gnn_cfg(arch), _np(grads), device="cpu"))
    return float(loss), {k: v.numpy() for k, v in named.items()}


def _ref_tree(params: dict) -> dict:
    """The port's parameters (``layers`` / ``blocks`` as lists) as the
    reference's numpy tree, those stacked on a leading axis."""
    leaves = lambda t: jax.tree.map(lambda v: v.detach().numpy(), t)
    return {k: (jax.tree.map(lambda *xs: np.stack(xs), *leaves(v))
                if k in ("layers", "blocks") else leaves(v))
            for k, v in params.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port: rank 0's results, ref: the reference's and the port's local
    results, the work directory).  The pool runs while this process
    computes the other side.  The parameters are the port's draws, carried
    to both sides."""
    work = str(tmp_path_factory.mktemp("mesh_train"))
    params = {f"gnn/{a}": _ref_tree(TG.init_params(C.gnn_cfg(a), 0,
                                                   device="cpu"))
              for a in C.ARCHS}
    params["fm"] = {k: v.numpy() for k, v in TR.init_params(
        TR.FMConfig(**C.FM_CFG), 0, device="cpu").items()}
    ref = {"params": params}
    with ThreadPoolExecutor(1 + len(C.ARCHS)) as pool, C.torch_threads(1):
        four = pool.submit(TM.spawn, C.run_cases, C.S, device="cpu",
                           init_file=os.path.join(work, "init4"),
                           grid=C.GRID, args=(params, work), timeout=300,
                           coll_timeout=C.COLL_TIMEOUT)
        rules = make_rules(None)
        # XLA compiles the four references side by side
        jitted = {a: pool.submit(_ref_gnn, a, params[f"gnn/{a}"])
                  for a in C.ARCHS}
        for a in C.ARCHS:
            ref[f"local/{a}"] = C.gnn_loss_grads(
                C.gnn_cfg(a), params[f"gnn/{a}"], C.gnn_inputs(a), rules)
        ref["local/gin_whole"] = C.gnn_loss_grads(
            C.gnn_cfg("gin"), params["gnn/gin"], C.gnn_inputs("gin", 66),
            rules)
        ref["uninterrupted"], _ = C.train_steps(
            C.gnn_cfg(C.RESUME_ARCH), params[f"gnn/{C.RESUME_ARCH}"],
            C.gnn_inputs(C.RESUME_ARCH), rules,
            os.path.join(work, "uninterrupted"), 2)
        ref.update({a: f.result() for a, f in jitted.items()})
        port = four.result()[0]
    # the 4-rank run's step-1 checkpoint (copied by rank 0) resumed on one
    # device
    ref["resume1"], _ = C.train_steps(
        C.gnn_cfg(C.RESUME_ARCH), params[f"gnn/{C.RESUME_ARCH}"],
        C.gnn_inputs(C.RESUME_ARCH), rules, os.path.join(work, "resume1"), 2)
    ref["fm_restored1"] = C.fm_restored(rules, work)
    return port, ref, work


def _close(got: float, want: float):
    assert abs(got - want) <= TOL * max(1.0, abs(want)), (got, want)


def _grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL * scale,
                                   err_msg=k)


def _entries(spec) -> tuple:
    """Spec entries with a one-name tuple written as the name, as the
    reference's ``PartitionSpec`` writes it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


class _StandIn:
    """A reference mesh's two attributes the rules read."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


@pytest.mark.parametrize("shape,names", [((2, 2), ("data", "model")),
                                         ((4, 1), ("data", "model")),
                                         ((2, 1, 2), ("pod", "data",
                                                      "model"))])
def test_rules_over_a_mesh_equal_reference(shape, names):
    mesh = TM.Mesh(None, 0, int(np.prod(shape)), torch.device("cpu"),
                   "gloo", shape=shape, axis_names=names)
    rules, ref = make_rules(mesh), RSH.make_rules(_StandIn(shape, names))
    logical = ("batch", "heads", "embed", "nodes", "rows", "expert", None)
    assert _entries(rules.spec(*logical)) == _entries(ref.spec(*logical))
    assert rules.dp_size() == ref.dp_size()
    with mock.patch.object(RSH, "NamedSharding", lambda m, spec: spec):
        for shp, ax in [((8, 5), ("rows", None)), ((6, 3), ("nodes", None)),
                        ((4,), ("batch",)), ((3, 8), (None, "ff")),
                        ((16, 4, 4), ("edges", None, None)), ((5,), ())]:
            want = _entries(ref.input_sharding(shp, *ax))
            want = want + (None,) * (len(shp) - len(want))
            got = _entries(rules.input_sharding(shp, *ax).entries)
            assert got == want, (shp, ax)
    x = torch.ones(2, 2)
    assert rules.constrain(x, "batch", None) is x


def test_rules_need_the_data_and_model_axes():
    mesh = TM.Mesh(None, 0, 4, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="'data', 'model'"):
        make_rules(mesh)


@pytest.mark.parametrize("arch", list(C.ARCHS))
def test_meshed_gnn_equals_reference_and_local(runs, arch):
    port, ref, _ = runs
    loss, grads = ref[arch]
    _close(port[f"gnn/{arch}/loss"], loss)
    _grads_close(port[f"gnn/{arch}/grads"], grads)
    local = ref[f"local/{arch}"]
    _close(port[f"gnn/{arch}/loss"], local[0])
    _grads_close(port[f"gnn/{arch}/grads"], local[1])
    assert port[f"gnn/{arch}/dropped"].reshape(-1).tolist() == [0] * C.S
    assert (port[f"gnn/{arch}/a2a"] > 0).all()    # the DGAS path was taken


@pytest.mark.parametrize("arch", list(C.ARCHS))
def test_rank_local_batch_gives_the_same_bits(runs, arch):
    """Every rank's step handed its block built by ``gnn.local_batch``
    gives the loss and the summed gradients of the step handed the global
    batch, bit for bit."""
    port, _, _ = runs
    assert port[f"gnn/{arch}/rank_batch_same"].reshape(-1).tolist() == \
        [1] * C.S


@pytest.mark.parametrize("case", ["gin_below", "gin_whole"])
def test_meshed_gnn_off_the_dgas_path(runs, case):
    """Below the threshold against the reference; at 66 nodes against the
    port's local path (itself held to the reference by
    tests/test_torch_gnn.py)."""
    port, ref, _ = runs
    loss, grads = ref["local/gin_whole" if case == "gin_whole" else "gin"]
    _close(port[f"gnn/{case}/loss"], loss)
    _grads_close(port[f"gnn/{case}/grads"], grads)


def test_overflow_drops_what_the_capacity_rule_gives(runs):
    port, _, _ = runs
    b = C.gnn_inputs("gin")
    src, x = b["src"], b["x"]
    E, per = src.shape[0] // C.S, 64 // C.S
    cap = min(E, C.OVERFLOW_FACTOR * -(-E // C.S))
    want_rows, want_drops = [], []
    for r in range(C.S):
        ids = src[r * E:(r + 1) * E]
        owner = np.where(ids >= 0, ids // per, -1)
        slot = np.zeros(E, np.int64)
        seen = {}
        for i, o in enumerate(owner):
            slot[i] = seen.get(o, 0)
            seen[o] = slot[i] + 1
        kept = (owner >= 0) & (slot < cap)
        want_drops.append(int(((owner >= 0) & ~kept).sum()))
        want_rows.append(np.where(kept[:, None], x[np.maximum(ids, 0)], 0))
    assert port["overflow/dropped"].reshape(-1).tolist() == want_drops
    assert sum(want_drops) > 0
    np.testing.assert_array_equal(port["overflow/rows"], np.stack(want_rows))


def test_meshed_fm_equals_reference(runs):
    port, ref, _ = runs
    cfg = RR.FMConfig(**C.FM_CFG)
    ids, labels = C.fm_inputs()
    params = {k: jnp.asarray(v) for k, v in ref["params"]["fm"].items()}
    want = np.asarray(RR.fm_scores(cfg, params, jnp.asarray(ids)))
    rows = port["fm/rows"].reshape(-1)
    np.testing.assert_allclose(port["fm/scores"].reshape(-1), want[rows],
                               rtol=TOL, atol=TOL)
    batch = {"ids": jnp.asarray(ids), "labels": jnp.asarray(labels)}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: RR.loss_fn(cfg, p, batch)[0]))(params)
    _close(port["fm/loss"], float(loss))
    _grads_close(port["fm/grads"], _np(grads))


def test_meshed_retrieval_equals_reference(runs):
    """Each rank scores its block of the candidates by their rows axis."""
    port, ref, _ = runs
    cfg = RR.FMConfig(**C.FM_CFG)
    ids, _ = C.fm_inputs()
    cand, bias = C.retrieval_inputs()
    params = {k: jnp.asarray(v) for k, v in ref["params"]["fm"].items()}
    want = RR.retrieval_scores(cfg, params, jnp.asarray(ids[:1]),
                               jnp.asarray(cand.numpy()),
                               jnp.asarray(bias.numpy()))
    np.testing.assert_allclose(port["fm/retrieval"].reshape(-1),
                               np.asarray(want), rtol=TOL, atol=TOL)


def test_quant_int8_bit_equal_to_reference():
    rng = np.random.default_rng(0)
    for x in (rng.standard_normal(1000).astype(np.float32) * 0.01,
              np.zeros(7, np.float32), np.float32([0.5, -1.5, 2.5, 127.0])):
        q, s = compression._quant_int8(torch.from_numpy(x))
        rq, rs = RCMP._quant_int8(jnp.asarray(x))
        assert q.numpy().tobytes() == np.asarray(rq).tobytes()
        assert np.float32(s.item()).tobytes() == np.asarray(rs).tobytes()


def test_compression_equals_the_reference_quantization(runs):
    port, _, _ = runs
    inputs = [C.compress_inputs(r) for r in range(C.S)]
    for k in C.COMPRESS_SHAPES:
        ef = [np.zeros(C.COMPRESS_SHAPES[k], np.float32)] * C.S
        for tag in ("int8", "int8_2"):
            xs = [inputs[r][k] + ef[r] for r in range(C.S)]
            qs = [RCMP._quant_int8(jnp.asarray(x)) for x in xs]
            qsum = sum(np.asarray(q).astype(np.int32) for q, _ in qs)
            smax = max(np.asarray(s) for _, s in qs)
            want = qsum.astype(np.float32) * smax
            assert port[f"compress/{k}/{tag}"].tobytes() == want.tobytes()
            ef = [x - np.asarray(q).astype(np.float32) * np.asarray(s)
                  for x, (q, s) in zip(xs, qs)]
            got_ef = port[f"compress/{k}/ef{1 if tag == 'int8' else 2}"]
            assert got_ef.tobytes() == np.stack(ef).tobytes()
        f32 = sum(inputs[r][k] for r in range(C.S))
        np.testing.assert_allclose(port[f"compress/{k}/f32"], f32, rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(port[f"compress/{k}/bf16"], f32,
                                   rtol=1e-2, atol=1e-3)
        # the reference's own tolerances (tests/_distributed_main.py), on
        # its own inputs: the same gradient on every rank.  With another
        # gradient a rank, the int8 sum dequantizes every rank's payload
        # with the largest scale, so it is held to the reference's bits
        # above, not to the f32 sum.
        same = inputs[0][k] * C.S
        np.testing.assert_allclose(port[f"compress/{k}/same_bf16"], same,
                                   rtol=1e-2, atol=1e-3)
        np.testing.assert_allclose(port[f"compress/{k}/same_int8"], same,
                                   rtol=0.05, atol=1e-3)
    b_f32, b_bf16, b_int8 = port["compress/bytes"]
    assert (b_bf16 * 2, b_int8 * 4) == (b_f32, b_f32)


def test_param_shardings_and_reshard_round_trip(runs):
    port, ref, _ = runs
    assert port["shardings"] == {"table": (("data", "model"), None),
                                 "w0": ()}
    table = ref["params"]["fm"]["table"]
    np.testing.assert_array_equal(port["reshard/table"].reshape(table.shape),
                                  table)
    assert port["reshard/back_equal"]


def test_sharded_checkpoint_reads_in_the_reference(runs):
    port, ref, work = runs
    shapes = {k: jax.ShapeDtypeStruct(np.shape(v), jnp.float32)
              for k, v in ref["params"]["fm"].items()}
    target = RA.TrainState(params=shapes, m=shapes, v=shapes,
                           step=jax.ShapeDtypeStruct((), jnp.int32))
    back = RCK.restore(os.path.join(work, "fm_ckpt"), 1, target)
    assert np.asarray(back.params["table"]).tobytes() == \
        port["fm_step/table"].tobytes()
    assert int(back.step) == 1
    assert port["fm_ckpt/same"]
    # the same sharded checkpoint restored onto 2 ranks' blocks and onto
    # one device
    for got in (port["fm_restored2"], ref["fm_restored1"]):
        assert got["table"].tobytes() == port["fm_step/table"].tobytes()
        assert got["w0"].tobytes() == np.asarray(back.params["w0"]).tobytes()


def test_resume_on_fewer_ranks_and_after_a_failure(runs):
    """The 4-rank run (a failure injected on every rank at step 2) equals
    an uninterrupted local run step for step; its step-1 checkpoint
    resumed on 2 ranks and on 1 gives its step 2."""
    port, ref, _ = runs
    losses = port["resume/losses"]
    assert sorted(losses) == [1, 2] and port["resume/restarts"] == 1
    for i in (1, 2):
        _close(losses[i], ref["uninterrupted"][i])
    _close(port["resume2/losses"][2], losses[2])
    one = ref["resume1"]
    assert sorted(one) == [2]
    _close(one[2], losses[2])


def test_make_mesh_over_some_ranks(runs):
    """``make_mesh(..., ranks=[1, 3])``: a (2, 1) mesh of world ranks 1
    and 3, in that order; the others get None."""
    port, _, _ = runs
    np.testing.assert_array_equal(port["submesh"],
                                  [[-1, -1], [4, 0], [-1, -1], [4, 1]])


def test_train_cli_under_a_four_rank_world(runs):
    port, _, _ = runs
    cli = port["cli"]
    assert [r["step"] for r in cli["logs"]] == [1, 2]
    assert cli["report"]["steps_run"] == 2
    assert all(np.isfinite(r["loss"]) for r in cli["logs"])


def test_lm_over_a_mesh_raises():
    """The name is kept from when any LM step over a mesh raised: the
    steps now exist (``tests/test_torch_mesh_lm.py`` runs them), and what
    still raises is an LM over a mesh without its parameters' placements,
    before any collective."""
    mesh = TM.Mesh(None, 0, 4, torch.device("cpu"), "gloo", shape=(2, 2),
                   axis_names=("data", "model"))
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    ac = get_config("qwen3-14b")
    step = TCOM.make_step(ac, TCOM.SpecBundle("train", ac.smoke, {}, {}),
                          make_rules(mesh))
    state = adamw.init_state(TT.Transformer(ac.smoke, device="cpu"))
    with pytest.raises(ValueError, match="placements"):
        step(state, {"tokens": torch.zeros(4, 8, dtype=torch.long)})


@pytest.mark.parametrize("tail", [(3,), (2, 3)])
def test_owner_side_update_drops_empty_slots(tail):
    """``offload.segment_sum_rows`` on CPU tensors (the plain version): a
    routed arrival buffer's rows summed by local id, the -1 of an empty
    slot and ids past the block dropped, equal to a float64 scatter-add
    within f32 rounding."""
    from repro_torch.core import offload
    rng = np.random.default_rng(5)
    n, slots = 50, 4 * 64
    ids = rng.integers(0, n, slots).astype(np.int32)
    ids[rng.random(slots) < 0.75] = -1
    ids[:4] = n
    rows = rng.standard_normal((slots,) + tail).astype(np.float32)
    got = offload.segment_sum_rows(torch.from_numpy(ids),
                                   torch.from_numpy(rows), n)
    ok = (ids >= 0) & (ids < n)
    want = np.zeros((n,) + tail)
    np.add.at(want, ids[ok], rows[ok].astype(np.float64))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
