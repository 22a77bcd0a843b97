"""Port parity for ``repro_torch.checkpoint.ckpt`` and
``repro_torch.distributed.fault_tolerance`` against the reference: the
cases of ``tests/test_checkpoint_ft.py`` on the port (round trip with
bf16, async saves with retention, a mismatched shape raises, a restart
after two injected failures resumes and converges), a checkpoint of an FM
``TrainState`` exchanged bit for bit between the packages in both
directions (the same keys: ``0/table``, ``0/w0``, ..., ``3``), and the
port's own traps: an async save takes its host copy before the step that
follows updates the parameters in place, and a module is restored in
place."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as RCK
from repro.configs import get_config as ref_config
from repro.models import recsys as RRS
from repro.optim import adamw as RA
from repro_torch.checkpoint.ckpt import (CheckpointManager, latest_step,
                                         restore, save)
from repro_torch.configs import get_config
from repro_torch.configs.common import init_params
from repro_torch.distributed.fault_tolerance import (FTConfig,
                                                     SimulatedFailure,
                                                     run_training)
from repro_torch.models import transformer as T
from repro_torch.optim import adamw


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones(5, dtype=torch.bfloat16),
                       "c": [torch.zeros(2, 2), torch.full((1,), 7.0)]}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 3, t)
    assert latest_step(str(tmp_path)) == 3
    target = {"a": torch.empty(3, 4, device="meta"),
              "nested": {"b": torch.empty(5, dtype=torch.bfloat16,
                                          device="meta"),
                         "c": [torch.empty(2, 2), torch.empty(1)]}}
    out = restore(str(tmp_path), 3, target, device="cpu")
    for a, b in zip(_leaves(t), _leaves(out)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_async_save_and_retention(tmp_path):
    t = _tree()
    mgr = CheckpointManager(str(tmp_path), every=1, keep=2)
    for s in range(1, 6):
        mgr.maybe_save(s, t)
    mgr.wait()
    steps = sorted(int(x.split("_")[1]) for x in os.listdir(tmp_path)
                   if x.startswith("step_"))
    assert steps == [4, 5]


def test_restore_mismatched_shape_raises(tmp_path):
    t = _tree()
    save(str(tmp_path), 0, t)
    bad = dict(t, a=torch.zeros(4, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(str(tmp_path), 0, bad)
    with pytest.raises(KeyError, match="missing leaf"):
        restore(str(tmp_path), 0, dict(t, z=torch.zeros(1)))


def test_ft_restart_resumes_and_converges(tmp_path):
    params = {"w": torch.full((4,), 5.0)}
    opt = adamw.AdamWConfig(lr=0.2, warmup_steps=0, total_steps=60,
                            weight_decay=0.0)
    state = adamw.init_state(params)
    seen = []

    def step_fn(state, batch):
        w = state.params["w"]         # the state's, never a closed-over one
        seen.append(id(w))
        w.grad = None
        loss = torch.sum((w - batch["t"]) ** 2)
        loss.backward()
        return adamw.apply_update(opt, state), {"loss": loss.detach()}

    def batches():
        while True:
            yield {"t": torch.zeros(4)}

    fails = {9, 23}

    def injector(step):
        if step in fails:
            fails.discard(step)
            raise SimulatedFailure()

    ckpt = CheckpointManager(str(tmp_path), every=5, keep=3)
    state, report = run_training(step_fn, state, batches(), ckpt, 40,
                                 FTConfig(ckpt_every=5),
                                 fail_injector=injector)
    assert report["restarts"] == 2
    assert report["steps_run"] == 40 + 4 + 3    # steps 5-8 and 20-22 again
    assert int(state.step) == 40
    assert abs(float(state.params["w"][0].detach())) < 1.0   # converged to 0
    assert len(set(seen)) == 3          # a restored tensor after each restart
    assert latest_step(str(tmp_path)) == 40


def test_async_save_copies_before_the_next_in_place_step(tmp_path):
    w = torch.arange(1 << 16, dtype=torch.float32)
    state = adamw.init_state({"w": w})
    writer = save(str(tmp_path), 1, state, async_=True)
    with torch.no_grad():
        w.add_(1.0)                   # the next step, while the writer runs
    writer.join()
    back = restore(str(tmp_path), 1, state)
    assert torch.equal(back.params["w"],
                       torch.arange(1 << 16, dtype=torch.float32))
    assert back.params["w"].requires_grad


def test_module_state_restores_in_place(tmp_path):
    cfg = get_config("qwen3-14b").smoke
    a = T.Transformer(cfg, seed=0, device="cpu")
    sa = adamw.init_state(a)
    save(str(tmp_path), 7, sa)
    b = T.Transformer(cfg, seed=1, device="cpu")
    sb = restore(str(tmp_path), 7, adamw.init_state(b))
    assert sb.params is b
    for (k, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), k
    assert set(sb.m) == set(dict(a.named_parameters()))


@pytest.fixture(scope="module")
def fm_state():
    """The reference's FM TrainState after one step (nonzero moments), as
    numpy, by checkpoint key."""
    rcfg = ref_config("fm").smoke
    rp = RRS.init_params(rcfg, jax.random.PRNGKey(0))
    st = RA.init_state(rp)
    g = jax.tree.map(lambda x: jnp.full(x.shape, 0.01, x.dtype), rp)
    st = RA.apply_update(RA.AdamWConfig(warmup_steps=0, total_steps=4), st,
                         g)
    host = jax.tree.map(np.asarray, (st.params, st.m, st.v, st.step))
    keys = {f"{i}/{k}": host[i][k] for i in range(3) for k in ("table", "w0")}
    keys["3"] = host[3]
    return st, keys


def _port_fm_target():
    ac = get_config("fm")
    return adamw.init_state(init_params(ac, ac.smoke, 5, device="cpu"))


def _port_by_key(st):
    out = {"3": st.step.numpy()}
    for i, part in enumerate((st.params, st.m, st.v)):
        for k in ("table", "w0"):
            out[f"{i}/{k}"] = part[k].detach().numpy()
    return out


def test_fm_checkpoint_from_the_reference_restores_bit_for_bit(tmp_path,
                                                               fm_state):
    st, want = fm_state
    RCK.save(str(tmp_path), 1, st)
    got = _port_by_key(restore(str(tmp_path), 1, _port_fm_target()))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape
        assert got[k].tobytes() == w.tobytes(), k


def test_fm_checkpoint_from_the_port_restores_bit_for_bit_in_reference(
        tmp_path, fm_state):
    st, want = fm_state
    port = _port_fm_target()
    for i, part in enumerate((port.params, port.m, port.v)):
        for k in ("table", "w0"):
            part[k].data = torch.from_numpy(want[f"{i}/{k}"].copy())
    port.step = torch.tensor(int(want["3"]), dtype=torch.int32)
    save(str(tmp_path), 2, port)
    back = RCK.restore(str(tmp_path), 2, jax.eval_shape(lambda: st))
    got = {"3": np.asarray(back.step)}
    for i, part in enumerate((back.params, back.m, back.v)):
        for k in ("table", "w0"):
            got[f"{i}/{k}"] = np.asarray(part[k])
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), k


def test_bf16_leaf_exchanged_both_ways(tmp_path):
    x = np.random.default_rng(0).standard_normal(37).astype(np.float32)
    ref_tree = {"p": jnp.asarray(x, jnp.bfloat16)}
    RCK.save(str(tmp_path / "r"), 0, ref_tree)
    got = restore(str(tmp_path / "r"), 0,
                  {"p": torch.empty(37, dtype=torch.bfloat16)})["p"]
    want = np.asarray(ref_tree["p"]).view(np.uint16)
    assert got.view(torch.int16).numpy().view(np.uint16).tobytes() == \
        want.tobytes()
    save(str(tmp_path / "t"), 0, {"p": got})
    back = RCK.restore(str(tmp_path / "t"), 0,
                       jax.eval_shape(lambda: ref_tree))["p"]
    assert back.dtype == jnp.bfloat16
    assert np.asarray(back).view(np.uint16).tobytes() == want.tobytes()
