"""The dry run (``repro_torch.launch.dryrun``) on the CPU: its model FLOPs
against the reference's (the parameter count through ``jax.eval_shape`` of
the reference's ``init_params``, as ``repro.launch.dryrun.model_flops``
counts it), its roofline against the reference's formula over the card's
``HW``, B4's and B6's torch operators on meta tensors (shapes, dtypes and
FLOPs against their plain versions and a hand count), ``kernels.cost``
against the bounds ``chip_smoke.py`` prints, and whole cells on both
production meshes.  No test builds or loads a kernel library.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as ref_config
from repro.configs import input_specs as ref_specs
from repro.models import transformer as RT
from repro_torch.configs import get_config, input_specs
from repro_torch.configs.common import SpecBundle
from repro_torch.core.graph import rmat
from repro_torch.distributed.sharding import make_rules
from repro_torch.kernels import _build, cost, ops, ref
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as TF
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

LM_ARCHS = ["mistral-large-123b", "qwen3-14b", "minicpm3-4b",
            "llama4-maverick-400b-a17b", "mixtral-8x7b"]
ROOT = os.path.join(os.path.dirname(__file__), "..")
H100_BYTES_PER_S, H100_BF16 = 3.35e12, 989e12


@pytest.fixture(scope="module", autouse=True)
def cli():
    """``python -m repro_torch.launch.dryrun`` on one cell, started when the
    module starts so it runs beside the other tests."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gin-tu", "--shape", "molecule"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    proc.kill()
    proc.communicate()


@pytest.fixture(autouse=True)
def no_kernel_library(monkeypatch):
    """A dry trace must never build or load a kernel library."""
    def refuse(name):
        raise AssertionError(f"a dry trace loaded the {name} library")
    monkeypatch.setattr(_build, "load", refuse)


def _ref_model_flops(arch: str, shape: str) -> float:
    """The reference's model FLOPs: N from ``jax.eval_shape`` of its
    ``init_params``, the MoE's active N, 6 N D for train, else 2 N D."""
    ac = ref_config(arch)
    bundle = ref_specs(ac, shape)
    cfg = bundle.model
    shapes = jax.eval_shape(lambda: RT.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    if cfg.moe is not None:
        m = cfg.moe
        layers = cfg.n_layers // m.period
        per = 3 * cfg.d_model * m.d_ff
        n = n - layers * m.n_experts * per + layers * max(m.top_k, 1) * per
    toks = int(np.prod(bundle.batch["tokens"].shape))
    return float(6 if bundle.kind == "train" else 2) * n * toks


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_model_flops_equal_the_references(arch, shape):
    ac = get_config(arch)
    assert D.model_flops(ac, input_specs(ac, shape)) == \
        _ref_model_flops(arch, shape)


def test_roofline_is_the_references_formula_over_the_card():
    assert M.HW["peak_bf16_flops"] == H100_BF16
    assert M.HW["hbm_bw"] == H100_BYTES_PER_S
    for flops, hbm, coll in ((1e12, 1e9, 1e8), (1e9, 1e12, 1e9),
                             (1e9, 1e9, 1e12), (0.0, 0.0, 0.0)):
        t_c, t_m = flops / M.HW["peak_bf16_flops"], hbm / M.HW["hbm_bw"]
        t_n = coll / M.HW["link_bw"]
        top = max(t_c, t_m, t_n)
        want = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_n,
                "dominant": max((t_c, "compute"), (t_m, "memory"),
                                (t_n, "collective"))[1],
                "bound_s": top,
                "roofline_fraction": (max(t_c, t_m) / max(top, 1e-30)
                                      if top > 0 else 0.0)}
        assert D.roofline_terms(flops, hbm, coll) == want


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("rows", [True, False])
def test_segment_sum_op_on_meta_matches_plain_and_counts(rows):
    rng = np.random.default_rng(0)
    t, d, m, e = 50, 8, 12, 70
    table = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    offsets = torch.from_numpy(np.sort(rng.integers(0, e if rows else t,
                                                    m + 1)))
    idx = torch.from_numpy(rng.integers(0, t, e).astype(np.int32)) \
        if rows else None
    want = ref.segment_sum_csr_ref(table, offsets, idx)
    with FlopCounterMode(display=False) as fc:
        got = ops.segment_sum_csr(table.to("meta"), offsets.to("meta"),
                                  None if idx is None else idx.to("meta"))
    assert got.device.type == "meta"
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    entries = e if rows else t
    assert fc.get_total_flops() == entries * d


def test_segment_plan_takes_the_sort_on_meta():
    seg = _meta(40, dtype=torch.int32)
    plan = ops._ss.SegmentPlan(seg, 9)
    assert plan.perm is not None and plan.perm.shape == (40,)
    assert plan.offsets.shape == (10,)
    cpu = ops._ss.SegmentPlan(torch.arange(40, dtype=torch.int32) // 5, 9)
    assert cpu.perm is None                     # sorted ids: no sort


ATTN = {  # B, Hq, Hkv, Sq, Skv, D, causal, window
    "prefill": (1, 4, 4, 64, 64, 32, True, None),
    "decode": (2, 8, 2, 1, 48, 16, True, None),
    "window": (1, 4, 2, 40, 40, 16, True, 8),
    "gqa": (2, 6, 2, 24, 24, 64, True, None),
    "ring": (1, 4, 2, 1, 16, 16, False, None),
}


@pytest.mark.parametrize("case", list(ATTN))
def test_flash_attention_op_on_meta_matches_plain_and_counts(case):
    B, Hq, Hkv, Sq, Skv, D_, causal, window = ATTN[case]
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(B, Hq, Sq, D_, generator=gen)
    k = torch.randn(B, Hkv, Skv, D_, generator=gen)
    v = torch.randn(B, Hkv, Skv, D_, generator=gen)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    with FlopCounterMode(display=False) as fc:
        got = ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                                  causal=causal, window=window)
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    visible = int(ref.attention_mask(Sq, Skv, causal, window, "cpu").sum())
    assert cost.visible_pairs(Sq, Skv, causal, window) == visible
    # q.k and the weighting of v, on the visible pairs only
    assert fc.get_total_flops() == 4 * D_ * B * Hq * visible


def test_cost_gives_the_bounds_perf_md_prints():
    # B4 on RMAT-20's in-edges at d 64 (1,048,576 segments, 16,085,114
    # entries), PERF.md's 1.3285268943283581 ms
    b4 = cost.segment_sum_bytes(16085114, 64, 1048576)
    assert 1e3 * b4 / H100_BYTES_PER_S == pytest.approx(1.3285268943283581,
                                                        rel=1e-12)
    # gin-tu's fused forward at d 100 on ogb_products: the gathered rows
    # and the table once (61,225,415 real edges, 2,449,408 rows)
    e, n = 61225415, 2449408
    assert 1e3 * cost.segment_sum_bytes(e, 100, n) / H100_BYTES_PER_S == \
        pytest.approx(7.676068913432836, rel=1e-12)
    assert 1e3 * cost.segment_sum_strict_bytes(n, e, 64, n) / \
        H100_BYTES_PER_S == pytest.approx(0.4533115904477612, rel=1e-12)
    # B6 at chip_smoke.py's four shapes (bf16, D 128, causal)
    for (B, hq, hkv, sq, skv, window), ms, by in (
            ((1, 40, 8, 4096, 4096, None), 0.17375190584428715,
             "operations"),
            ((128, 40, 8, 1, 32768, None), 5.12910167880597, "bytes"),
            ((1, 32, 8, 8192, 8192, 4096), 0.4169367187542973, "operations"),
            ((1, 40, 8, 1, 32768, None), 0.04007110686567164, "bytes")):
        flops = cost.attention_flops(B, hq, sq, skv, 128, True, window)
        nbytes = cost.attention_bytes(B * hq * sq * 128, B * hkv * skv * 128,
                                      2)
        s, got = cost.bound_s(nbytes, flops, M.HW)
        assert got == by and 1e3 * s == pytest.approx(ms, rel=1e-12)


def test_bbcsr_bytes_counts_each_real_slot_once():
    from repro_torch.core.graph import to_bbcsr
    from repro_torch.core import engine
    g = rmat(8, 8, seed=3, device="cpu")
    bb = to_bbcsr(g, block_rows=64, block_cols=64, tile_nnz=64)
    real = int(bb.tile_cnt.long().sum())
    assert real == g.nnz
    fixed = (4 * (bb.n_row_blocks + 1) + 4 * bb.n_col_blocks * bb.block_cols
             + 4 * bb.n_rows)
    assert cost.bbcsr_bytes(bb) == 12 * real + 8 * bb.n_tiles + fixed
    act = engine.tile_active(bb, (torch.arange(g.n_rows) < 40).int())
    live = int(bb.tile_cnt[act != 0].long().sum())
    assert cost.bbcsr_bytes(bb, act) == 12 * live + 8 * int(
        (act != 0).sum()) + 4 * bb.n_tiles + fixed


def test_production_meshes_lay_out_a_ranks_view():
    one = M.make_production_mesh(rank=37)
    assert (one.shape, one.axis_names, one.backend) == \
        ((16, 16), ("data", "model"), "dry")
    assert one.coord("data") == (2, 16) and one.coord("model") == (5, 16)
    assert one.over("model").rank == 5 and one.over("data").rank == 2
    two = M.make_production_mesh(multi_pod=True, rank=300)
    assert two.size == 512 and two.over(("pod", "data")).size == 32
    x = torch.empty(6, 4, device="meta")
    y = two.over("model").all_reduce(x)
    z = two.over("data").all_gather(x)
    assert y.device.type == "meta" and z.shape == (16, 6, 4)
    assert two.calls == {"all_to_all": 0, "all_reduce": 1, "all_gather": 1}
    assert two.bytes["all_gather"] == 96


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("cell", [("gin-tu", "molecule"),
                                  ("fm", "serve_p99")])
def test_run_cell_on_both_production_meshes(cell, multi_pod):
    rec = D.run_cell(*cell, multi_pod=multi_pod)
    assert rec["status"] == "ok" and rec["per_device"]["fits_80gb"]
    assert rec["n_chips"] == (512 if multi_pod else 256)
    pd = rec["per_device"]
    assert pd["collective_bytes"] == sum(c["bytes"] for c in
                                         rec["collectives"].values()) > 0
    assert pd["memory"]["argument_size_in_bytes"] > 0
    if cell[0] == "gin-tu":
        assert pd["kernel_calls"]["segment_sum"] > 0 and pd["flops"] > 0


def test_a_steps_arguments_are_its_state_and_batch():
    ac = get_config("qwen3-14b")
    cfg = ac.smoke
    tokens = torch.empty((2, 16), dtype=torch.int32, device="meta")
    bundle = SpecBundle("train", cfg, {"tokens": tokens}, {})
    got = D.dry_step(ac, bundle, make_rules(None))
    model = TF.init_params(cfg, device="meta")
    n = sum(p.numel() * p.element_size() for p in model.parameters())
    moments = 2 * sum(p.numel() * 4 for p in model.parameters())
    assert got["argument_bytes"] == n + moments + 4 + tokens.numel() * 4
    assert got["peak_bytes"] > got["argument_bytes"]
    assert got["collectives"] == {}


def test_the_cli_runs_a_cell(cli):
    out, err = cli.communicate(timeout=120)
    assert cli.returncode == 0, err[-2000:]
    assert " ok " in out and "fit=True" in out
