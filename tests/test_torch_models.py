"""Port parity for the model stack's serving path: ``repro_torch.models``
(transformer, FM), ``repro_torch.data.synthetic`` and
``repro_torch.launch.serve`` against the reference, on the same numpy
inputs.  The reference's parameters come from its ``init_params`` and are
carried across by ``params_from_reference``; each reference output is
computed once per module (module-scoped fixtures), its decode jitted once
per config.

Tolerances: rtol 1e-4 / atol 1e-5 in f32 for the transformer (the
reference's online softmax against the port's exact one), 1e-6 for FM,
bytes for the synthetic batches.  Also: the reference's feature cases
(``tests/test_transformer_features.py``) on the port, the ring past the
window, the initialisers' moments, the attention route per config, and
the device rule.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import graph as RG
from repro.data import synthetic as RSYN
from repro.models import recsys as RRS
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.core import graph as TG
from repro_torch.data import synthetic as TSYN
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as TSERVE
from repro_torch.models import recsys as TRS
from repro_torch.models import transformer as T
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

LM_ARCHS = ["qwen3-14b", "minicpm3-4b", "mixtral-8x7b", "mistral-large-123b",
            "llama4-maverick-400b-a17b"]
RTOL, ATOL = 1e-4, 1e-5
B, S, P = 2, 12, 8                 # forward length; prefill P, decode S - P


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cfg(ref_cfg, **kw):
    """The port's LMConfig with the fields of a reference LMConfig (the
    reference's ``q_chunk``, which the port lacks, dropped)."""
    f = {k.name: getattr(ref_cfg, k.name) for k in dataclasses.fields(T.LMConfig)}
    f["dtype"] = torch.float32
    if f["moe"] is not None:
        f["moe"] = T.MoEConfig(**dataclasses.asdict(f["moe"]))
    if f["mla"] is not None:
        f["mla"] = T.MLAConfig(**dataclasses.asdict(f["mla"]))
    f.update(kw)
    return T.LMConfig(**f)


@functools.lru_cache(maxsize=None)
def _carried(ref_cfg, seed=0):
    """(reference params, port model with the same parameters, port cfg);
    one draw per config for the module (no test changes the parameters)."""
    rp = RT.init_params(ref_cfg, jax.random.PRNGKey(seed))
    cfg = _port_cfg(ref_cfg)
    model = T.Transformer(cfg, device="cpu")
    model.load_state_dict(T.params_from_reference(cfg, _np(rp)))
    return rp, model, cfg


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _pad_ref_cache(cache, extra):
    return {k: (jnp.pad(v, ((0, 0),) * 3 + ((0, extra),)
                        + ((0, 0),) * (v.ndim - 4)) if v.ndim >= 4 else v)
            for k, v in cache.items()}


def _ref_decode_fn(ref_cfg):
    return jax.jit(lambda p, c, t: RT.decode_step(ref_cfg, p, c, t))


# ---------------------------------------------------------------------------
# every LM smoke config: forward, prefill + cache, 4 decode steps, loss
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=LM_ARCHS)
def lm_case(request):
    arch = request.param
    rcfg = ref_config(arch).smoke
    rp, model, cfg = _carried(rcfg)
    toks = np.random.default_rng(1).integers(0, rcfg.vocab, (B, S)
                                             ).astype(np.int32)
    jt = jnp.asarray(toks)
    # one jit for the three whole-sequence calls: eager dispatch costs more
    fwd, (lg, cache), loss = jax.jit(lambda p, t: (
        RT.forward(rcfg, p, t), RT.prefill(rcfg, p, t[:, :P]),
        RT.loss_fn(rcfg, p, {"tokens": t})))(rp, jt)
    ref = {"forward": _np(fwd), "prefill": _np((lg, cache)),
           "loss": _np(loss)}
    dec = _ref_decode_fn(rcfg)
    cache = _pad_ref_cache(cache, S - P)
    steps = []
    for t in range(P, S):
        lg, cache = dec(rp, cache, jt[:, t:t + 1])
        steps.append(_np(lg))
    ref["decode"] = np.stack(steps)
    return arch, cfg, model, toks, ref


def test_forward_matches_reference(lm_case):
    _, cfg, model, toks, ref = lm_case
    with torch.no_grad():
        logits, aux = T.forward(cfg, model, torch.from_numpy(toks))
    assert logits.shape == (B, S, cfg.vocab)
    _close(logits, ref["forward"][0])
    _close(aux, ref["forward"][1], atol=1e-6)


def test_prefill_logits_and_cache_match_reference(lm_case):
    _, cfg, model, toks, ref = lm_case
    logits, cache = T.prefill(cfg, model, torch.from_numpy(toks[:, :P]))
    want_lg, want_cache = ref["prefill"]
    assert logits.dtype == torch.float32
    _close(logits, want_lg)
    got = T.cache_to_reference(cfg, cache)
    assert set(got) == set(want_cache) and int(got["len"]) == P
    for k in want_cache:
        assert got[k].shape == want_cache[k].shape, k
        _close(got[k], want_cache[k])


def test_decode_steps_match_reference(lm_case):
    _, cfg, model, toks, ref = lm_case
    _, cache = T.prefill(cfg, model, torch.from_numpy(toks[:, :P]))
    cache = T.grow_cache(cache, S)
    for i, t in enumerate(range(P, S)):
        lg, cache = T.decode_step(cfg, model, cache,
                                  torch.from_numpy(toks[:, t:t + 1]))
        _close(lg, ref["decode"][i])
    assert cache["len"] == S


def test_loss_matches_reference(lm_case):
    _, cfg, model, toks, ref = lm_case
    with torch.no_grad():
        loss, m = T.loss_fn(cfg, model, {"tokens": toks})
    want, wm = ref["loss"]
    _close(loss, want)
    _close(m["loss"], wm["loss"])
    assert int(m["ntok"]) == int(wm["ntok"]) == B * (S - 1)


def test_decode_matches_forward(lm_case):
    """The reference's test_smoke_lm_decode_matches_forward on the port."""
    _, cfg, model, toks, ref = lm_case
    cache = T.init_cache(cfg, B, S, device="cpu")
    for t in range(S):
        lg, cache = T.decode_step(cfg, model, cache,
                                  torch.from_numpy(toks[:, t:t + 1]))
    _close(lg, ref["forward"][0][:, -1], rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# the ring past the window: a prompt longer than mixtral smoke's window 8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prompt,gen", [(12, 6), (8, 10)])
def test_serve_past_the_window_matches_reference(prompt, gen):
    """Prefill a prompt, size the cache as serve does, decode greedily: the
    reference's serve loop and ``serve_lm`` give the same tokens and
    logits, whether the prefilled cache is longer than the window (its
    ring wraps with only the newest 8 slots visible) or the cache is the
    window itself."""
    rcfg = ref_config("mixtral-8x7b").smoke
    rp, model, cfg = _carried(rcfg)
    prompts = np.random.default_rng(prompt).integers(
        0, rcfg.vocab, (B, prompt)).astype(np.int32)
    max_len = TSERVE.cache_len_for(cfg, prompt, gen)
    lg, cache = RT.prefill(rcfg, rp, jnp.asarray(prompts))
    if max_len > prompt:
        cache = _pad_ref_cache(cache, max_len - prompt)
    dec = _ref_decode_fn(rcfg)
    want, tok = [], jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
    for _ in range(gen):
        want.append(np.asarray(tok)[:, 0])
        lg, cache = dec(rp, cache, tok)
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
    got = TSERVE.serve_lm(cfg, model, prompts, gen)
    assert max_len == (prompt if prompt > rcfg.window else rcfg.window)
    np.testing.assert_array_equal(got["tokens"], np.stack(want, 1))
    _close(got["logits"], lg)


# ---------------------------------------------------------------------------
# the reference's feature cases, on the port against the reference
# ---------------------------------------------------------------------------

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab=97, q_chunk=8, k_chunk=8, dtype=jnp.float32)


def _decode_all(cfg, model, toks, cache_len):
    cache = T.init_cache(cfg, toks.shape[0], cache_len, device="cpu")
    for t in range(toks.shape[1]):
        lg, cache = T.decode_step(cfg, model, cache,
                                  torch.from_numpy(toks[:, t:t + 1]))
    return lg


def _ref_decode_all(rcfg, rp, toks, cache_len):
    dec = _ref_decode_fn(rcfg)
    cache = RT.init_cache(rcfg, toks.shape[0], cache_len)
    for t in range(toks.shape[1]):
        lg, cache = dec(rp, cache, jnp.asarray(toks[:, t:t + 1]))
    return np.asarray(lg)


def test_swa_ring_cache_matches_full_cache():
    rcfg = RT.LMConfig(name="swa", window=8, **BASE)
    rp, model, cfg = _carried(rcfg)
    toks = np.random.default_rng(0).integers(0, 97, (2, 20)).astype(np.int32)
    ring = _decode_all(cfg, model, toks, 8)          # wraps 2.5x
    full = _decode_all(cfg, model, toks, 20)         # no wrap
    _close(ring, full, atol=1e-4)
    _close(ring, _ref_decode_all(rcfg, rp, toks, 8))


def test_mla_latent_cache_is_small_and_consistent():
    mla = RT.MLAConfig(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                       nope_head_dim=16, v_head_dim=16)
    rcfg = RT.LMConfig(name="mla", mla=mla, **BASE)
    rp, model, cfg = _carried(rcfg)
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    assert cache["ckv"][0].shape == (2, 16, 16)
    assert cache["krope"][0].shape == (2, 16, 8)
    assert "k" not in cache
    toks = np.random.default_rng(1).integers(0, 97, (2, 16)).astype(np.int32)
    with torch.no_grad():
        logits, _ = T.forward(cfg, model, torch.from_numpy(toks))
    want, _ = RT.forward(rcfg, rp, jnp.asarray(toks))
    _close(logits, want)
    lg = _decode_all(cfg, model, toks, 16)
    _close(lg, logits[:, -1], rtol=1e-3, atol=1e-3)
    _close(lg, _ref_decode_all(rcfg, rp, toks, 16))


def test_moe_capacity_drops_match_reference():
    rcfg = RT.LMConfig(name="moe", moe=RT.MoEConfig(
        n_experts=4, top_k=2, d_ff=64, capacity_factor=0.5), **BASE)
    rp, model, cfg = _carried(rcfg)
    rng = np.random.default_rng(2)
    # 512 tokens x top-2 over 4 experts against a capacity of 128: the
    # overflow sink is used
    x = rng.standard_normal((4, 128, 64)).astype(np.float32)
    p = model.layers[0].moe
    with torch.no_grad():
        out, aux = T._moe_ffn(cfg, p, torch.from_numpy(x),
                              T.make_rules(None))
        routed = torch.topk(torch.from_numpy(x).reshape(-1, 64) @ p["router"],
                            2, dim=-1).indices
    assert int(torch.bincount(routed.reshape(-1)).max()) > 128
    toks = rng.integers(0, 97, (2, 32)).astype(np.int32)
    (rout, raux), (want, waux) = jax.jit(lambda p, x, t: (
        RT._moe_ffn(rcfg, jax.tree.map(lambda a: a[0],
                                       p["layers"]["sub0"]["moe"]),
                    x, RT.make_rules(None)),
        RT.forward(rcfg, p, t)))(rp, jnp.asarray(x), jnp.asarray(toks))
    _close(out, rout)
    _close(aux, raux, atol=1e-6)
    with torch.no_grad():
        logits, aux = T.forward(cfg, model, torch.from_numpy(toks))
    assert torch.isfinite(logits).all() and float(aux) > 0
    _close(logits, want)
    _close(aux, waux, atol=1e-6)


def test_fused_qkv_same_structure_loss():
    rcfg = RT.LMConfig(name="fused", fused_qkv=True, **BASE)
    rp, model, cfg = _carried(rcfg)
    names = dict(model.named_parameters())
    assert "layers.0.attn.wqkv" in names and "layers.0.mlp.w13" in names
    toks = np.random.default_rng(3).integers(0, 97, (2, 16)).astype(np.int32)
    with torch.no_grad():
        loss, _ = T.loss_fn(cfg, model, {"tokens": toks})
    want, _ = RT.loss_fn(rcfg, rp, {"tokens": jnp.asarray(toks)})
    _close(loss, want)
    unfused = T.Transformer(_port_cfg(RT.LMConfig(name="u", **BASE)),
                            device="cpu")
    assert T.count_params(model) == T.count_params(unfused) == \
        RT.count_params(rp)


def test_vocab_padding_sliced_from_logits():
    rcfg = RT.LMConfig(name="pad", **BASE)
    rp, model, cfg = _carried(rcfg)
    assert cfg.vocab_padded == 256 and model.embed.shape[0] == 256
    toks = np.random.default_rng(4).integers(0, 97, (1, 8)).astype(np.int32)
    with torch.no_grad():
        logits, _ = T.forward(cfg, model, torch.from_numpy(toks))
    assert logits.shape[-1] == 97
    _close(logits, RT.forward(rcfg, rp, jnp.asarray(toks))[0])


def test_prefill_then_decode_continuity():
    rcfg = RT.LMConfig(name="gqa", **BASE)
    rp, model, cfg = _carried(rcfg)
    toks = np.random.default_rng(5).integers(0, 97, (2, 16)).astype(np.int32)
    want, _ = RT.forward(rcfg, rp, jnp.asarray(toks))
    _, cache = T.prefill(cfg, model, torch.from_numpy(toks[:, :12]))
    cache = T.grow_cache(cache, 16)
    for t in range(12, 16):
        lg, cache = T.decode_step(cfg, model, cache,
                                  torch.from_numpy(toks[:, t:t + 1]))
    _close(lg, np.asarray(want)[:, -1], atol=1e-4)


def test_cache_round_trips_through_the_reference_layout():
    rcfg = ref_config("llama4-maverick-400b-a17b").smoke    # period 2
    rp, model, cfg = _carried(rcfg)
    toks = jnp.asarray(np.arange(10, dtype=np.int32).reshape(2, 5))
    _, rc = RT.prefill(rcfg, rp, toks)
    rc = _np(rc)
    back = T.cache_to_reference(cfg, T.cache_from_reference(cfg, rc,
                                                            device="cpu"))
    for k in rc:
        np.testing.assert_array_equal(back[k], rc[k])


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rmsnorm_and_rope_match_reference(dtype):
    """rmsnorm in f32 cast back; RoPE over half-split pairs (x[:half] with
    x[half:]), at positions past the prompt."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    w = rng.random(16).astype(np.float32) + 0.5
    pos = np.arange(10, 20).reshape(2, 5)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, jnp.dtype(dtype).name))
    tol = 1e-6 if dtype == np.float32 else 1e-2
    _close(T.rmsnorm(tx, torch.from_numpy(w)),
           RT.rmsnorm(jx, jnp.asarray(w)).astype(jnp.float32), tol, tol)
    got = T.rope(tx, torch.from_numpy(pos), 1e6)
    assert got.dtype == tx.dtype
    _close(got, RT.rope(jx, jnp.asarray(pos), 1e6).astype(jnp.float32),
           tol, tol)


# ---------------------------------------------------------------------------
# initialisers, routes, the device rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_shapes_and_dtypes_match_reference(arch):
    rcfg = ref_config(arch).smoke
    tree = jax.eval_shape(lambda: RT.init_params(rcfg, jax.random.PRNGKey(0)))
    want = T.params_from_reference(
        _port_cfg(rcfg), jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                      tree))
    cfg = get_config(arch).smoke
    got = T.Transformer(cfg, device="cpu").state_dict()
    assert set(got) == set(want)
    for k, t in want.items():
        assert got[k].shape == t.shape and got[k].dtype == t.dtype, k


def test_init_moments_and_bf16():
    cfg = T.LMConfig(name="init", n_layers=1, d_model=256, n_heads=8,
                     n_kv_heads=4, head_dim=32, d_ff=512, vocab=512,
                     qk_norm=True, dtype=torch.bfloat16)
    model = T.Transformer(cfg, seed=3, device="cpu")
    fan = {"wq": 256, "wk": 256, "wv": 256, "wo": 256, "w1": 256, "w3": 256,
           "w2": 512, "embed": 256, "lm_head": 256}
    seen = 0
    for name, p in model.named_parameters():
        leaf = name.split(".")[-1]
        if leaf in ("ln1", "ln2", "final_norm", "q_norm", "k_norm"):
            assert p.dtype == torch.float32 and bool((p == 1).all()), name
            continue
        assert p.dtype == torch.bfloat16, name
        target = fan[leaf] ** -0.5
        w = p.detach().float()
        assert abs(float(w.mean())) < 0.05 * target, name
        assert abs(float(w.std()) / target - 1) < 0.05, name
        seen += 1
    assert seen == 9


def test_attention_route_per_config(monkeypatch):
    """GQA configs send attention to ops.flash_attention (B6 on the card),
    MLA (minicpm3) to the online softmax (``online_attention``) on prefill
    and to its absorbed latent form on decode, by configuration."""
    calls, online = [], []
    real, real_online = tops.flash_attention, T.online_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    def spy_online(*a, **kw):
        online.append(a[0].shape)
        return real_online(*a, **kw)

    monkeypatch.setattr(tops, "flash_attention", spy)
    monkeypatch.setattr(T, "online_attention", spy_online)
    for arch in LM_ARCHS:
        cfg = get_config(arch).smoke
        want = "online" if arch == "minicpm3-4b" else "flash"
        assert T.attention_route(cfg) == want
        assert T.attention_route(get_config(arch).model) == want
        model = T.Transformer(cfg, device="cpu")
        calls.clear()
        online.clear()
        _, cache = T.prefill(cfg, model, torch.zeros((1, 4), dtype=torch.long))
        T.decode_step(cfg, model, T.grow_cache(cache, 5),
                      torch.zeros((1, 1), dtype=torch.long))
        assert len(calls) == (0 if want == "online" else 2 * cfg.n_layers)
        assert len(online) == (cfg.n_layers if want == "online" else 0)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the rule is that CUDA is used")
    cfg = get_config("qwen3-14b").smoke
    with pytest.raises(RuntimeError, match="CUDA"):
        T.Transformer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TRS.init_params(get_config("fm").smoke, device="cuda")


# ---------------------------------------------------------------------------
# FM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fm_case():
    rcfg = ref_config("fm").smoke
    rp = _np(RRS.init_params(rcfg, jax.random.PRNGKey(0)))
    params = {k: torch.from_numpy(v.copy()) for k, v in rp.items()}
    batch = next(RSYN.recsys_batches(64, rcfg.n_fields, rcfg.rows_per_field,
                                     seed=3))
    return rcfg, get_config("fm").smoke, rp, params, batch


def test_fm_scores_and_loss_match_reference(fm_case):
    rcfg, cfg, rp, params, batch = fm_case
    ids = batch["ids"].copy()
    ids[0, 0] = -1                                 # out of range: fill 0
    want = RRS.fm_scores(rcfg, rp, jnp.asarray(ids))
    _close(TRS.fm_scores(cfg, params, ids), want, rtol=1e-6, atol=1e-6)
    loss, m = TRS.loss_fn(cfg, params, batch)
    wloss, wm = RRS.loss_fn(rcfg, rp, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    _close(loss, wloss, rtol=1e-6, atol=1e-6)
    assert float(m["acc"]) == float(wm["acc"])
    assert TSERVE.score_fm(cfg, params, batch["ids"])["scores"].shape == (64,)


def test_fm_retrieval_matches_reference(fm_case):
    rcfg, cfg, rp, params, batch = fm_case
    rng = np.random.default_rng(9)
    cand = rng.standard_normal((1000, rcfg.embed_dim)).astype(np.float32)
    bias = rng.standard_normal(1000).astype(np.float32)
    want = RRS.retrieval_scores(rcfg, rp, jnp.asarray(batch["ids"][:1]),
                                jnp.asarray(cand), jnp.asarray(bias))
    got = TRS.retrieval_scores(cfg, params, batch["ids"][:1],
                               torch.from_numpy(cand), torch.from_numpy(bias))
    _close(got, want, rtol=1e-6, atol=1e-6)


def test_fm_dgas_with_a_mesh_raises(fm_case):
    """The name is kept from when the DGAS lookup raised.  Over a 1-rank
    (1, 1) mesh it routes each lookup through the mesh and gives the local
    scores, loss and gradients; rules need a ('data', 'model') mesh."""
    import _torch_mesh_cases as MC
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import Mesh
    _, cfg, _, params, batch = fm_case
    cfg = dataclasses.replace(cfg, use_dgas=True)

    def run(rules):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        scores = TRS.fm_scores(cfg, p, batch["ids"], rules)
        loss, _ = TRS.loss_fn(cfg, p, batch, rules)
        loss.backward()
        return [t.detach().numpy() for t in (scores, loss, p["table"].grad,
                                             p["w0"].grad)]

    want = run(None)
    with MC.one_rank_mesh() as mesh:
        got = run(make_rules(mesh))
        assert mesh.calls["all_to_all"] > 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="'data', 'model'"):
        make_rules(Mesh(None, 0, 1, torch.device("cpu"), "gloo"))


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------

def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def test_lm_and_recsys_batches_byte_equal():
    a, b = TSYN.lm_batches(4, 33, 1000, seed=5), \
        RSYN.lm_batches(4, 33, 1000, seed=5)
    c, d = TSYN.recsys_batches(16, 6, 1000, seed=5), \
        RSYN.recsys_batches(16, 6, 1000, seed=5)
    for _ in range(2):
        _same(next(a), next(b))
        _same(next(c), next(d))
    _same(next(TSYN.prefetch(TSYN.lm_batches(2, 8, 50, seed=1))),
          next(RSYN.lm_batches(2, 8, 50, seed=1)))


@pytest.mark.parametrize("arch", ["gin_tu", "gatedgcn", "dimenet",
                                  "equiformer_v2"])
def test_gnn_batch_byte_equal(arch):
    tg = TG.uniform_random_graph(48, 3, seed=1, device="cpu")
    rg = RG.uniform_random_graph(48, 3, seed=1)
    kw = dict(l_max=2, seed=4, graph_id=np.zeros(48, np.int32))
    _same(TSYN.gnn_batch(arch, tg, 7, 3, **kw),
          RSYN.gnn_batch(arch, rg, 7, 3, **kw))


def test_sampled_gnn_batch_and_graphs_equal():
    for shape in ("molecule", "full_graph_sm", "minibatch_lg"):
        tg = TSYN.graph_for_shape(shape, seed=2, scale_override=7,
                                  device="cpu")
        rg = RSYN.graph_for_shape(shape, seed=2, scale_override=7)
        np.testing.assert_array_equal(tg.indptr.numpy(), np.asarray(rg.indptr))
        np.testing.assert_array_equal(tg.indices.numpy(),
                                      np.asarray(rg.indices))
    feats = np.random.default_rng(0).standard_normal((tg.n_rows, 5)
                                                      ).astype(np.float32)
    labels = np.arange(tg.n_rows, dtype=np.int32) % 7
    got = TSYN.sampled_gnn_batch(tg, feats, labels, 16, (5, 3), seed=6)
    want = RSYN.sampled_gnn_batch(rg, feats, labels, 16, (5, 3), seed=6)
    _same(got, want)
