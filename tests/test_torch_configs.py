"""Port parity for the config registry and the sharding rules:
``repro_torch.configs`` and ``repro_torch.distributed.sharding`` against
``repro.configs`` / ``repro.distributed.sharding``.

The registry names the reference's architectures, each full and smoke
config equal field for field over the port's fields (the reference's
``q_chunk``, which its attention ignores, is not ported), every
``input_specs`` shape and dtype equal to the reference's (the decode cache
per layer, (B, Kv, Smax, hd) against the reference's stacked (G, P, B,
Smax, Kv, hd)), ``make_step``'s prefill / decode / serve / retrieval steps
equal to the model calls, its train step and the training state's shapes
and logical axes (by parameter name) equal to the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.configs import piuma_graph as RPG
from repro.distributed import sharding as RSH
from repro.models import gnn as RG
from repro.models import transformer as RT
import repro_torch.configs as TC
from repro_torch.configs import common as TCOM
from repro_torch.configs import piuma_graph as TPG
from repro_torch.distributed import sharding as TSH
from repro_torch.launch import mesh as TM
from repro_torch.models import gnn as TG
from repro_torch.models import recsys as TRS
from repro_torch.models import transformer as T

GNN = ("equiformer-v2", "dimenet", "gatedgcn", "gin-tu")
PORTED = list(RC.ARCH_NAMES)


# the reference LMConfig's field that no code of it reads
TRAIN_ONLY = {"q_chunk"}
# the reference GNNConfig's fields the port lacks: none since the meshed
# DGAS branch, which reads dgas_threshold and dgas_cap_factor
MESH_ONLY = set()


def _grid_mesh():
    """Rank 0's view of a (2, 2) ('data', 'model') mesh: the rules read
    its axes alone, so no process group is made."""
    return TM.Mesh(None, 0, 4, torch.device("cpu"), "gloo", shape=(2, 2),
                   axis_names=("data", "model"))


def _plain(x, like=None):
    """A config as nested plain values, over the fields of ``like`` (the
    port's counterpart, where given); dtypes by name."""
    like = x if like is None else like
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name), getattr(like, f.name))
                for f in dataclasses.fields(like)}
    if isinstance(x, dict):
        return {k: _plain(v, like.get(k, v) if isinstance(like, dict) else v)
                for k, v in x.items()}
    if isinstance(x, torch.dtype):
        return str(x).removeprefix("torch.")
    if isinstance(x, type) or isinstance(x, np.dtype):
        return jnp.dtype(x).name
    return x


def test_registry_names_are_the_reference_minus_gnn():
    """The name is kept from when the GNNs were missing; the registry now
    equals the reference's, GNNs included."""
    assert TC.ARCH_NAMES == RC.ARCH_NAMES
    for name in GNN:
        assert TC.get_config(name).family == "gnn"
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("gpt-17")


@pytest.mark.parametrize("arch", PORTED)
def test_configs_equal_field_for_field(arch):
    want, got = RC.get_config(arch), TC.get_config(arch)
    assert _plain(got) == _plain(want, got)
    assert TCOM.shape_names(got) == RC.shape_names(want)


def test_lm_config_lacks_only_the_training_fields():
    names = lambda c: {f.name for f in dataclasses.fields(c)}
    assert names(RT.LMConfig) - names(T.LMConfig) == TRAIN_ONLY
    assert names(T.LMConfig) <= names(RT.LMConfig)


def test_gnn_config_lacks_only_the_mesh_fields():
    names = lambda c: {f.name for f in dataclasses.fields(c)}
    assert names(RG.GNNConfig) - names(TG.GNNConfig) == MESH_ONLY
    assert names(TG.GNNConfig) <= names(RG.GNNConfig)


def test_piuma_graph_config_equal():
    assert _plain(TPG.config()) == _plain(RPG.config())


def _spec(s):
    return tuple(s.shape), str(s.dtype).removeprefix("torch.")


def _ref_spec(s):
    return tuple(s.shape), jnp.dtype(s.dtype).name


@pytest.mark.parametrize("arch", PORTED)
def test_input_specs_equal_reference(arch):
    rac, tac = RC.get_config(arch), TC.get_config(arch)
    for shape in RC.shape_names(rac):
        if shape in rac.skips:
            with pytest.raises(ValueError, match="skips"):
                TC.input_specs(tac, shape)
            continue
        want, got = RC.input_specs(rac, shape), TC.input_specs(tac, shape)
        assert got.kind == want.kind
        assert got.batch_axes == want.batch_axes
        assert {k: _spec(v) for k, v in got.batch.items()} == \
            {k: _ref_spec(v) for k, v in want.batch.items()}
        assert all(v.device.type == "meta" for v in got.batch.values())
        if want.cache is None:
            assert got.cache is None
            continue
        cfg = tac.model
        for name, ref in want.cache.items():
            if name == "len":
                continue
            layers = got.cache[name]
            assert len(layers) == cfg.n_layers
            G, P = ref.shape[:2]
            assert G * P == cfg.n_layers
            per = tuple(ref.shape[2:])
            if name in ("k", "v"):            # (B, Smax, Kv, hd) -> (B, Kv, Smax, hd)
                per = (per[0], per[2], per[1], per[3])
            assert all(_spec(t) == (per, jnp.dtype(ref.dtype).name)
                       for t in layers), name
        assert set(got.cache_axes) == set(want.cache_axes)


def test_mixtral_long500k_uses_ring_cache():
    b = TC.input_specs(TC.get_config("mixtral-8x7b"), "long_500k")
    assert b.cache["k"][0].shape[2] == TC.get_config("mixtral-8x7b").model.window


def test_apply_variant_and_training_parts_raise():
    """The name is kept from when the training parts raised: the train
    step, the state's shapes and axes, the GNN specs and parameter
    shardings over a mesh now work, and so do an LM's train, prefill and
    decode steps over a mesh (``tests/test_torch_mesh_lm.py`` runs
    them)."""
    tac = TC.get_config("qwen3-14b")
    b = TCOM.apply_variant(TC.input_specs(tac, "prefill_32k"), "fused_qkv")
    assert b.model.fused_qkv
    assert TCOM.apply_variant(b, None) is b
    gac = TC.get_config("equiformer-v2")
    g = TCOM.apply_variant(TC.input_specs(gac, "ogb_products"), "chunk_128k")
    assert g.model.edge_chunk == 131072
    train = TC.input_specs(tac, "train_4k")
    assert callable(TC.make_step(tac, train, TSH.make_rules(None)))
    params, state = TC.state_shapes(tac, tac.smoke)
    axes = TC.state_logical_axes(tac, tac.smoke, params)
    assert set(state.m) == set(axes.m) == set(dict(params.named_parameters()))
    assert state.step.device.type == "meta" and axes.step == ()
    pax = TCOM.param_logical_axes(tac, tac.smoke, params)
    assert TC.param_shardings(TSH.make_rules(None), params, pax) == {
        k: None for k in pax}
    rules = TSH.make_rules(_grid_mesh())
    sh = TC.param_shardings(rules, params, pax)
    assert set(sh) == set(pax)
    for k, ax in pax.items():
        shape = tuple(dict(params.named_parameters())[k].shape)
        assert sh[k] == rules.input_sharding(shape, *ax)
    fac = TC.get_config("fm")
    fpax = TCOM.param_logical_axes(fac, fac.model, None)
    fsh = TC.param_shardings(rules, TC.state_shapes(fac, fac.model)[0], fpax)
    assert fsh["table"].entries == (("data", "model"), None)
    assert fsh["w0"].replicated
    for kind in ("train", "prefill", "decode"):
        assert callable(TC.make_step(
            tac, TCOM.SpecBundle(kind, tac.smoke, {}, {}), rules))
    assert TCOM._gnn_specs(gac, "molecule").kind == "train"


@pytest.mark.parametrize("arch", ["qwen3-14b", "minicpm3-4b"])
def test_make_step_prefill_decode_equal_model_calls(arch):
    tac = TC.get_config(arch)
    cfg = tac.smoke
    rules = TSH.make_rules(None)
    model = TC.init_params(tac, cfg, 0, device="cpu")
    assert isinstance(model, T.Transformer)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 6)).astype(np.int32))
    pre = TC.make_step(tac, TCOM.SpecBundle("prefill", cfg, {}, {}), rules)
    dec = TC.make_step(tac, TCOM.SpecBundle("decode", cfg, {}, {}), rules)
    lg, cache = pre(model, {"tokens": toks})
    want_lg, want_cache = T.prefill(cfg, model, toks)
    assert torch.equal(lg, want_lg)
    cache, want_cache = T.grow_cache(cache, 7), T.grow_cache(want_cache, 7)
    nxt = toks[:, :1]
    lg, cache = dec(model, cache, {"tokens": nxt})
    want_lg, _ = T.decode_step(cfg, model, want_cache, nxt)
    assert torch.equal(lg, want_lg) and cache["len"] == 7


def test_make_step_serve_retrieval_equal_model_calls():
    tac = TC.get_config("fm")
    cfg = tac.smoke
    rules = TSH.make_rules(None)
    params = TC.init_params(tac, cfg, 1, device="cpu")
    assert params["table"].shape == (cfg.n_rows_padded, 1 + cfg.embed_dim)
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, cfg.n_rows, (8, cfg.n_fields)
                                        ).astype(np.int32))
    serve = TC.make_step(tac, TCOM.SpecBundle("serve", cfg, {}, {}), rules)
    assert torch.equal(serve(params, {"ids": ids}),
                       TRS.fm_scores(cfg, params, ids))
    cand = torch.from_numpy(rng.standard_normal((64, cfg.embed_dim)
                                                ).astype(np.float32))
    bias = torch.zeros(64)
    ret = TC.make_step(tac, TCOM.SpecBundle("retrieval", cfg, {}, {}), rules)
    batch = {"ids": ids[:1], "cand": cand, "cand_bias": bias}
    assert torch.equal(ret(params, batch),
                       TRS.retrieval_scores(cfg, params, ids[:1], cand, bias))


def test_one_device_rules():
    rules, ref = TSH.make_rules(None), RSH.make_rules(None)
    assert TSH.LOGICAL == RSH.LOGICAL
    assert rules.mesh is None and rules.dp_size() == ref.dp_size() == 1
    x = torch.ones(2, 3)
    assert rules.constrain(x, "batch", "seq_sp") is x
    assert rules.spec("batch", "heads", None) == tuple(ref.spec("batch",
                                                                "heads", None))
    with pytest.raises(KeyError):
        rules.constrain(x, "nonsense")
    # over a mesh the rules need its ('data', 'model') axes
    with pytest.raises(ValueError, match="'data', 'model'"):
        TSH.make_rules(TM.Mesh(None, 0, 4, torch.device("cpu"), "gloo"))
    assert TSH.make_rules(_grid_mesh()).dp_size() == 2


def test_serve_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "12", "--gen", "4"])
    serve.main(["--arch", "fm", "--smoke", "--device", "cpu", "--batch",
                "16"])
    out = capsys.readouterr().out
    assert "prefill 2x12" in out and "tok/s" in out
    assert "scored 16 requests" in out and "not measured" in out
