"""Port parity for ``repro_torch.optim.adamw`` against ``repro.optim.adamw``:
the same numpy parameters, moments and gradients through several steps of
both (f32 and bf16 moments, with and without clipping, across the warmup
and the cosine decay), within 1e-6 relative; the schedule itself; and the
port's guard, which raises where a parameter that requires grad has no
gradient (the gradient was lost: no silent skip)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro_torch.optim import adamw as TA

RTOL = 1e-6


def _tree(rng, dtype=np.float32):
    return {"w": rng.standard_normal((4, 3)).astype(dtype),
            "ln": np.ones(3, dtype),
            "blocks": [{"b": rng.standard_normal(5).astype(dtype)},
                       {"b": rng.standard_normal(5).astype(dtype)}],
            "eps": np.asarray(0.5, dtype)}


def _torch_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v, dtype) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32)).to(dtype)


def _named_np(tree):
    """The reference tree's leaves by the port's names, as f32 numpy."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, x in enumerate(node):
                walk(x, path + (str(i),))
        else:
            out["/".join(path)] = np.asarray(node, np.float32)
    walk(tree, ())
    return out


CFGS = {
    "clip": RA.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8),
    "no_clip": RA.AdamWConfig(lr=5e-3, clip_norm=None, weight_decay=0.3,
                              warmup_steps=0, total_steps=5,
                              min_lr_frac=0.2),
    "tight_clip": RA.AdamWConfig(lr=1e-2, clip_norm=0.05, warmup_steps=1,
                                 total_steps=6, beta2=0.99),
}


def _port_cfg(rcfg, moment):
    f = {k: getattr(rcfg, k) for k in rcfg.__dataclass_fields__}
    f["moment_dtype"] = moment
    return TA.AdamWConfig(**f)


@pytest.mark.parametrize("moments", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(CFGS))
def test_steps_match_reference(name, moments):
    rng = np.random.default_rng(0)
    jdt, tdt = ((jnp.float32, torch.float32) if moments == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    rcfg = CFGS[name]
    tree = _tree(rng)
    rs = RA.init_state_with_dtype(jax.tree.map(jnp.asarray, tree), jdt)
    ts = TA.init_state_with_dtype(_torch_tree(tree, torch.float32), tdt)
    assert ts.step.dtype == torch.int32 and ts.step.dim() == 0
    assert all(m.dtype == tdt for m in ts.m.values())
    for i in range(5):
        g = _tree(rng)
        g["w"] *= 10.0 ** (i - 2)           # norms on both sides of the clip
        rs = RA.apply_update(rcfg, rs, jax.tree.map(jnp.asarray, g))
        named = TA.named_params(ts.params)
        for k, a in _named_np(g).items():
            named[k].grad = torch.from_numpy(a)
        TA.apply_update(_port_cfg(rcfg, tdt), ts)
    assert int(ts.step) == int(rs.step) == 5
    for part in ("params", "m", "v"):
        want = _named_np(getattr(rs, part))
        got = (TA.named_params(ts.params) if part == "params"
               else getattr(ts, part))
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].dtype == (torch.float32 if part == "params"
                                    else tdt)
            np.testing.assert_allclose(got[k].detach().float().numpy(), w,
                                       rtol=RTOL, atol=RTOL * np.abs(w).max(),
                                       err_msg=f"{name} {moments} {part} {k}")


def test_schedule_matches_reference():
    cfg = RA.AdamWConfig(lr=2.0, warmup_steps=10, total_steps=110,
                         min_lr_frac=0.1)
    tcfg = _port_cfg(cfg, torch.float32)
    for s in [0, 1, 5, 10, 11, 60, 109, 110, 200]:
        want = float(RA.cosine_schedule(cfg, jnp.asarray(s)))
        got = float(TA.cosine_schedule(tcfg, torch.tensor(s,
                                                         dtype=torch.int32)))
        assert got == pytest.approx(want, rel=RTOL, abs=1e-7), s


def test_global_norm_and_bf16_params_update_in_place():
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    want = float(RA.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(TA.global_norm(TA.named_params(_torch_tree(tree,
                                                           torch.float32))))
    assert got == pytest.approx(want, rel=RTOL)
    params = _torch_tree(tree, torch.bfloat16)
    st = TA.init_state_with_dtype(params, torch.bfloat16)
    ids = {k: id(p) for k, p in TA.named_params(params).items()}
    for p in TA.named_params(params).values():
        p.grad = torch.ones_like(p)
    out = TA.apply_update(TA.AdamWConfig(warmup_steps=0, total_steps=2), st)
    assert out is st
    for k, p in TA.named_params(st.params).items():
        assert id(p) == ids[k] and p.dtype == torch.bfloat16
        assert bool(torch.isfinite(p.float()).all())


def test_missing_gradient_raises():
    model = torch.nn.Linear(3, 2)
    st = TA.init_state(model)
    model(torch.ones(1, 3))[0, 0].backward()
    model.bias.grad = None                 # a gradient the backward lost
    with pytest.raises(RuntimeError, match="no gradient"):
        TA.apply_update(TA.AdamWConfig(), st)
    assert int(st.step) == 0               # nothing was applied
    model.bias.grad = torch.zeros(2)
    TA.apply_update(TA.AdamWConfig(), st)
    assert int(st.step) == 1
    assert set(st.m) == {"weight", "bias"}
