"""MLA serving through the reference's online softmax (``transformer``'s
``online_attention``, the forward :class:`FlashAttention` runs, over
``k_chunk``-key blocks): minicpm3's smoke prefill and ``forward`` against
the live reference (the tolerance of ``tests/test_torch_models.py``) and
against the plain route (``kernels.ref.flash_attention_ref``, 1e-5
relative); the function alone against the plain version and against the
training attention's forward bits; and a meta trace of minicpm3-4b's
prefill at S = 4096, whose temporaries stay below one (heads x S) x S f32
logit block, the plain route's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.launch import dryrun as D
from repro_torch.models import transformer as T
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-4, 1e-5            # tests/test_torch_models.py's
PLAIN_RTOL = 1e-5                  # the online route vs the plain route
B, S, P = 2, 12, 8


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


@pytest.fixture(scope="module")
def minicpm3():
    """(port cfg, port model, tokens, the reference's forward and prefill
    logits) on the reference's parameters carried across."""
    rcfg = ref_config("minicpm3-4b").smoke
    # jitted: the reference's eager init takes seconds op by op
    rp = jax.jit(lambda k: RT.init_params(rcfg, k))(jax.random.PRNGKey(0))
    fields = {k.name: getattr(rcfg, k.name)
              for k in dataclasses.fields(T.LMConfig)}
    fields.update(dtype=torch.float32,
                  mla=T.MLAConfig(**dataclasses.asdict(rcfg.mla)))
    cfg = T.LMConfig(**fields)
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(T.params_from_reference(
        cfg, jax.tree.map(np.asarray, rp)))
    toks = np.random.default_rng(1).integers(0, rcfg.vocab, (B, S)
                                             ).astype(np.int32)
    (fwd, _), (lg, _) = jax.tree.map(np.asarray, jax.jit(lambda p, t: (
        RT.forward(rcfg, p, t), RT.prefill(rcfg, p, t[:, :P])))(
            rp, jnp.asarray(toks)))
    return cfg, model, torch.from_numpy(toks), fwd, lg


def _port(cfg, model, toks):
    with torch.no_grad():
        fwd, _ = T.forward(cfg, model, toks)
    lg, _ = T.prefill(cfg, model, toks[:, :P])
    return fwd, lg


def test_mla_serving_matches_the_reference_and_the_plain_route(
        minicpm3, monkeypatch):
    cfg, model, toks, ref_fwd, ref_lg = minicpm3
    assert T.attention_route(cfg) == "online"
    calls = []
    real = T.online_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(T, "online_attention", counted)
    fwd, lg = _port(cfg, model, toks)
    assert len(calls) == 2 * cfg.n_layers        # forward, then prefill
    np.testing.assert_allclose(fwd.numpy(), ref_fwd, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lg.numpy(), ref_lg, rtol=RTOL, atol=ATOL)
    monkeypatch.setattr(T, "online_attention", lambda q, k, v, *, causal,
                        window, k_chunk: ref.flash_attention_ref(
                            q, k, v, causal=causal, window=window))
    p_fwd, p_lg = _port(cfg, model, toks)
    assert _rel(fwd, p_fwd) <= PLAIN_RTOL
    assert _rel(lg, p_lg) <= PLAIN_RTOL


@pytest.mark.parametrize("causal,window,sq,skv", [
    (True, None, 100, 100), (True, 24, 100, 100), (False, None, 37, 130)])
def test_online_attention_equals_the_plain_version(causal, window, sq, skv):
    """GQA (2 q heads a kv head), q / k width 12 and v width 8 (MLA's
    shape of widths), key counts no block divides evenly into 64."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 4, sq, 12, generator=gen)
    k = torch.randn(2, 2, skv, 12, generator=gen)
    v = torch.randn(2, 2, skv, 8, generator=gen)
    got = T.online_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.shape == want.shape == (2, 4, sq, 8)
    assert _rel(got, want) <= PLAIN_RTOL
    # the training attention's forward is the same body: the same bits
    qg = q.clone().requires_grad_(True)
    assert torch.equal(T.flash_attn(qg, k, v, causal=causal,
                                    window=window).detach(), got)


def test_minicpm3_prefill_temporaries_stay_below_one_logit_block():
    """minicpm3-4b at its published widths, prefill 1 x 4096 on one card,
    traced on meta: the temporaries (peak less the arguments) stay below
    the (heads x S) x S f32 logits the plain route held at once.  Depth
    cut to 2 of 62 layers (a layer's temporaries are freed before the
    next; the cache a layer adds is 2 MB), so the trace takes a second."""
    cfg = dataclasses.replace(get_config("minicpm3-4b").model, n_layers=2)
    S4 = 4096
    model = T.init_params(cfg, device="meta")
    toks = torch.zeros((1, S4), dtype=torch.int32, device="meta")
    got = D.trace(lambda m, t: T.prefill(cfg, m, t), model, toks)
    block = cfg.n_heads * S4 * S4 * 4
    temp = got["peak_bytes"] - got["argument_bytes"]
    assert 0 < temp < block, (temp, block)
