"""Port parity for the training path: the transformer's autograd attention,
``loss_fn`` gradients, ``configs.make_step``'s train step and the train
CLI, against the reference on the same numpy inputs and carried
parameters (its side computed once per module).

- :class:`transformer.FlashAttention` against the reference's custom-VJP
  ``_flash_attn`` (GQA, causal, window, Dv != D as MLA's, a ``k_chunk``
  that does not divide S): outputs and gradients within 1e-5; and against
  the plain version ``kernels.ref.flash_attention_ref``, whose backward
  now runs.
- ``loss_fn`` gradients of the qwen3 (GQA, qk-norm), minicpm3 (MLA) and
  mixtral (MoE, window) smoke configs against ``jax.grad``: rtol 1e-4,
  atol 1e-5 of each gradient's largest element.
- One ``make_step`` train step per family (lm, gnn, recsys) against the
  reference's ``make_step``: loss, parameters and moments after the step.
- Losses decreasing over 8 steps on a repeated batch, as
  ``tests/test_arch_smoke.py`` holds the reference; a train step never
  calls B6 (``ops.flash_attention``), inference still does.
- ``python -m repro_torch.launch.train`` with ``--device cpu``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs.common import SpecBundle as RSpec
from repro.configs.common import init_params as ref_init
from repro.configs.common import make_step as ref_make_step
from repro.core.graph import uniform_random_graph
from repro.data import synthetic as RSYN
from repro.distributed.sharding import make_rules as ref_rules
from repro.models import transformer as RT
from repro.optim import adamw as RA
from repro_torch.configs import get_config
from repro_torch.configs.common import SpecBundle, init_params, make_step
from repro_torch.distributed.sharding import make_rules
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import gnn as G
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

LM_GRAD_ARCHS = ["qwen3-14b", "minicpm3-4b", "mixtral-8x7b"]
LM_ARCHS = LM_GRAD_ARCHS + ["mistral-large-123b", "llama4-maverick-400b-a17b"]
RULES = make_rules(None)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the autograd attention
# ---------------------------------------------------------------------------

# (B, H, Kv, S, D, Dv, causal, window, k_chunk)
ATTN_CASES = {
    "gqa_causal": (2, 4, 2, 12, 16, 16, True, None, 8),     # block 6 of 12
    "window": (1, 4, 2, 13, 16, 16, True, 4, 5),             # 13 is prime
    "mla_dv": (2, 4, 4, 12, 24, 16, True, None, 4),
    "full": (1, 6, 3, 10, 8, 8, False, None, 16),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_matches_reference_vjp(case):
    B, H, Kv, S, D, Dv, causal, window, kc = ATTN_CASES[case]
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Kv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Kv, Dv)).astype(np.float32)
    do = rng.standard_normal((B, S, H, Dv)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: RT._flash_attn(
        a, b, c, causal, window, 0, kc, D ** -0.5), *map(jnp.asarray,
                                                         (q, k, v)))
    want = [out] + list(vjp(jnp.asarray(do)))
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2).requires_grad_(True)
                  for a in (q, k, v))
    got = T.flash_attn(tq, tk, tv, causal=causal, window=window, k_chunk=kc)
    got.backward(torch.from_numpy(do).transpose(1, 2))
    for name, g, w in zip(("out", "dq", "dk", "dv"),
                          (got.detach(), tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"{case} {name}")


def test_plain_attention_is_differentiable_and_agrees():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                ).requires_grad_(True)
               for s in ((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)))
    do = torch.from_numpy(rng.standard_normal((1, 4, 8, 16)).astype(
        np.float32))
    out = flash_attention_ref(q, k, v, causal=True, window=3)
    grads = torch.autograd.grad(out, (q, k, v), do)
    out2 = T.flash_attn(q, k, v, causal=True, window=3, k_chunk=4)
    grads2 = torch.autograd.grad(out2, (q, k, v), do)
    for a, b in zip((out,) + grads, (out2,) + grads2):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_train_step_never_calls_b6_and_inference_does():
    ac = get_config("qwen3-14b")
    cfg = ac.smoke
    model = init_params(ac, cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 10)).astype(np.int32))
    calls = []
    real = ops.flash_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    ops.flash_attention = spy
    try:
        step = make_step(ac, SpecBundle("train", cfg, {}, {}), RULES)
        step(adamw.init_state(model), {"tokens": toks})
        assert calls == []
        with torch.no_grad():
            T.forward(cfg, model, toks)
        T.prefill(cfg, model, toks)
        assert len(calls) == 2 * cfg.n_layers
    finally:
        ops.flash_attention = real


def test_remat_changes_no_gradient():
    ac = get_config("mixtral-8x7b")
    grads = {}
    for remat in (True, False):
        cfg = T.LMConfig(**{**ac.smoke.__dict__, "remat": remat})
        model = T.Transformer(cfg, seed=0, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab, (2, 16)).astype(np.int32))
        T.loss_fn(cfg, model, {"tokens": toks})[0].backward()
        grads[remat] = {k: p.grad for k, p in model.named_parameters()}
    for k, g in grads[True].items():
        torch.testing.assert_close(g, grads[False][k], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# loss_fn gradients against jax.grad
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=LM_GRAD_ARCHS)
def lm_grad_case(request):
    arch = request.param
    rcfg = ref_config(arch).smoke
    rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, rcfg.vocab, (2, 24)).astype(
        np.int32)
    (loss, m), grads = jax.jit(jax.value_and_grad(
        lambda p: RT.loss_fn(rcfg, p, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(rp)
    return arch, _np(rp), toks, float(loss), float(m["loss"]), _np(grads)


def test_lm_loss_gradients_match_jax_grad(lm_grad_case):
    arch, rp, toks, loss, nll, grads = lm_grad_case
    cfg = get_config(arch).smoke
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(T.params_from_reference(cfg, rp))
    total, m = T.loss_fn(cfg, model, {"tokens": torch.from_numpy(toks)})
    total.backward()
    assert float(total.detach()) == pytest.approx(loss, rel=1e-5)
    assert float(m["loss"].detach()) == pytest.approx(nll, rel=1e-5)
    want = T.params_from_reference(cfg, grads)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].grad is not None, k
        np.testing.assert_allclose(
            got[k].grad.numpy(), w.numpy(), rtol=1e-4,
            atol=1e-5 * float(w.abs().max()), err_msg=f"{arch} {k}")


# ---------------------------------------------------------------------------
# make_step's train step, one per family
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)


def _ref_batch(ac, cfg):
    rng = np.random.default_rng(3)
    if ac.family == "lm":
        return {"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(
            np.int32)}
    if ac.family == "recsys":
        return next(RSYN.recsys_batches(16, cfg.n_fields,
                                        cfg.rows_per_field))
    g = uniform_random_graph(40, 3, seed=2)
    return RSYN.gnn_batch(cfg.arch, g, cfg.d_feat, cfg.n_classes,
                          l_max=cfg.l_max)


def _carry(ac, cfg, rp):
    if ac.family == "lm":
        model = T.Transformer(cfg, device="cpu")
        model.load_state_dict(T.params_from_reference(cfg, rp))
        return model
    if ac.family == "gnn":
        return G.params_from_reference(cfg, rp, device="cpu")
    return {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}


@pytest.mark.parametrize("arch", ["qwen3-14b", "gin-tu", "fm"])
def test_make_step_train_matches_reference(arch):
    rac, ac = ref_config(arch), get_config(arch)
    rcfg, cfg = rac.smoke, ac.smoke
    rp = ref_init(rac, rcfg, jax.random.PRNGKey(0))
    batch = _ref_batch(rac, rcfg)
    rstep = jax.jit(ref_make_step(rac, RSpec("train", rcfg, {}, {}),
                                  ref_rules(None), RA.AdamWConfig(**OPT)))
    rs, rm = rstep(RA.init_state_with_dtype(rp, rac.moment_dtype),
                   {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_step(ac, SpecBundle("train", cfg, {}, {}), RULES,
                     adamw.AdamWConfig(**OPT))
    ts = adamw.init_state_with_dtype(_carry(ac, cfg, _np(rp)),
                                     ac.moment_dtype)
    ts, tm = step(ts, {k: torch.from_numpy(np.array(v))
                       for k, v in batch.items()})
    assert int(ts.step) == int(rs.step) == 1
    assert float(tm["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    rtree = {"params": _np(rs.params), "m": _np(rs.m), "v": _np(rs.v)}
    for part in ("params", "m", "v"):
        want = _carry(ac, cfg, rtree[part])
        want = adamw.named_params(want)
        got = (adamw.named_params(ts.params) if part == "params"
               else getattr(ts, part))
        assert set(got) == set(want)
        for k, w in want.items():
            w = w.detach().float().numpy()
            np.testing.assert_allclose(
                got[k].detach().float().numpy(), w, rtol=1e-4,
                atol=1e-4 * max(float(np.abs(w).max()), 1e-12),
                err_msg=f"{arch} {part} {k}")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_lm_losses_decrease(arch):
    """A few steps on a repeated batch must reduce the loss."""
    ac = get_config(arch)
    cfg = ac.smoke
    state = adamw.init_state_with_dtype(init_params(ac, cfg, 0, device="cpu"),
                                        ac.moment_dtype)
    step = make_step(ac, SpecBundle("train", cfg, {}, {}), RULES,
                     adamw.AdamWConfig(lr=1e-2, warmup_steps=0,
                                       total_steps=30, weight_decay=0.0))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32))}
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], f"{arch}: {losses}"
    assert int(state.step) == 8


def test_train_cli_runs_on_the_cpu_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train
    args = ["--arch", "gin-tu", "--smoke", "--device", "cpu", "--steps", "3",
            "--log-every", "1", "--gnn-nodes", "64", "--ckpt-dir",
            str(tmp_path)]
    first = train.main(args)
    out = capsys.readouterr().out
    assert "devices=1 (cpu)" in out and "done: 3 steps" in out
    assert [r["step"] for r in first["logs"]] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in first["logs"])
    again = train.main(args)            # resumes at step 3: nothing to run
    assert again["report"]["steps_run"] == 0
    assert "done: 0 steps" in capsys.readouterr().out
    train.main(["--arch", "fm", "--smoke", "--device", "cpu", "--steps", "2",
                "--batch", "16", "--ckpt-dir", str(tmp_path / "fm")])
    assert "done: 2 steps" in capsys.readouterr().out
