#!/usr/bin/env python3
"""Smoke run of the torch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--scale 20] [--out build/chip_smoke.json]

Phases, each of which exits non-zero on failure:

1. device: the card's name, capability, and its name and power limit as
   ``nvidia-smi`` reports them;
2. build: compiles ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a);
3. kernel parity on an RMAT graph (``rmat(scale, 16, seed=7)``, default
   256/512/512 tile geometry): each BBCSR kernel against its plain torch
   version on the card — SpMV (B1), SpMSpV 'add' on a frontier touching
   about 1% of the column blocks (B2), SpMSpV 'min' / 'max' all-active and
   sparse (B3); min/max exact, 'add' within rtol 1e-5 / atol 1e-5; B1
   and B2 run twice on the same inputs must give equal bits (``[repro]``);
4. the main path through the port's public entry points, each path with
   the launch counts zeroed just before it and read just after: SpMV,
   BFS on the unit pull operand, SSSP on the (min,+) operand (both against
   the plain engine, bit-equal), PageRank (mass 1 within 1e-3) and
   connected components;
5. kernel timings with CUDA events beside their byte bound, the plain
   version and, where one exists, a library call computing the same
   function (timed here only; the port never calls it), and B1 / B3 on the
   heaviest row block's tiles alone beside the full launch (``[time]
   heaviest row block``: does the launch follow that block?);
6. ops: the kernel entry point ``repro_torch.kernels.ops`` at the repo's
   configs' full widths, each call with its kernel's launch count zeroed
   just before it and read just after, each kernel held against its plain
   version on the same inputs and timed beside its bound, the plain version
   and a library call: ``segment_sum_sorted`` (B4) on gin-tu's aggregation
   over the RMAT graph's in-edges (d 64), ``embedding_bag`` (B5) on fm
   serving (39 fields x 1M rows: ``serve_bulk`` batch 262,144 as a sum and
   as a weighted mean with 10% of ids -1, ``serve_p99`` batch 512 as a
   sum, each with the bytes of its rows' 32-byte sectors beside its byte
   bound, for information), ``flash_attention`` (B6)
   at qwen3-14b prefill 4096 and decode over 32768 keys at batch 128 and
   at batch 1 and at mixtral-8x7b's 4096-token window over 8192; each B6
   call must take the path the wrapper's dispatch rule gives it (the
   wgmma kernel for prefill and window, the folded kernel with its keys
   split for the batch-1 decode, unsplit at batch 128), read from the
   per-path launch counts, and its case names that path.

Prints one JSON line ``{"kernels": [...]}`` and, last, the device line.
The embedding_bag entry's times are those of the bulk sum; its launches
and max_abs_err cover the three checked calls, and each case's own numbers
are in its ``cases``.
The flash_attention entry's times are those of one shape, the one
furthest from its bound, named in its ``shape`` key; its launches and
max_abs_err cover every checked call; each shape's own numbers are in its
``cases``.
Needs one card; on a host without one it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor cores
ADD_RTOL = ADD_ATOL = 1e-5         # kernel vs plain, f32 'add'
# B4: f32 atomics in no fixed order, runs of up to ~1e5 rows (RMAT hubs),
# against a float64-accumulated plain version
SEG_TOL = 1e-4
# B5: each bag is summed in stream order in f32, 39 rows: a few ulps of
# the float64-accumulated plain version
BAG_TOL = 1e-5
# B6 bf16: the kernel rounds the probabilities to bf16 for the second
# product and the output to bf16 (2^-8 relative each); the plain version
# runs in f32 and rounds once.  Each (b, head, position) row is held to
# ||kernel - plain|| / ||plain|| <= ATTN_ROW_TOL, and each element to
# rtol ATTN_TOL plus atol ATTN_TOL times min(1, the plain row's RMS): rows
# that average thousands of keys sit near 0.03, so an absolute 5e-2 would
# pass a wrong kernel.  A planted fault (each row's own 64-key block, the
# last one the kernel visits, left out) must fail the same check.
ATTN_TOL = 5e-2
ATTN_ROW_TOL = 1e-2
FAULT_BLOCK = 64
SOURCE = {"spmv_bbcsr": "src/repro_torch/csrc/bbcsr.cu",
          "spmspv_bbcsr_add": "src/repro_torch/csrc/bbcsr.cu",
          "spmspv_bbcsr_select": "src/repro_torch/csrc/bbcsr.cu",
          "segment_sum": "src/repro_torch/csrc/segment_sum.cu",
          "embedding_bag": "src/repro_torch/csrc/embedding_bag.cu",
          "flash_attention": "src/repro_torch/csrc/flash_attention.cu"}
REPLACES = {"spmv_bbcsr": "src/repro/kernels/spmv_dma.py:206",
            "spmspv_bbcsr_add": "src/repro/kernels/spmv_dma.py:235",
            "spmspv_bbcsr_select": "src/repro/kernels/spmv_dma.py:235",
            "segment_sum": "src/repro/kernels/segment_sum.py:45",
            "embedding_bag": "src/repro/kernels/embedding_bag.py:43",
            "flash_attention": "src/repro/kernels/flash_attention.py:75"}


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(bb, tile_active=None) -> float:
    """Least time at the card's memory rate for the bytes the kernel must
    move on these inputs: 12 B per real slot of the tiles it processes,
    their tile_cb and tile_cnt, the tile_active flags (SpMSpV), rb_ptr, x
    (padded) and y."""
    import torch
    live = bb.tile_cnt if tile_active is None else \
        torch.where(tile_active != 0, bb.tile_cnt, 0)
    n_live = bb.n_tiles if tile_active is None else \
        int((tile_active != 0).sum())
    nbytes = (12 * int(live.long().sum()) + 8 * n_live
              + (0 if tile_active is None else 4 * bb.n_tiles)
              + 4 * (bb.n_row_blocks + 1)
              + 4 * bb.n_col_blocks * bb.block_cols + 4 * bb.n_rows)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def heaviest_block_diagnostic(bb, rb_slots, x, all_act, reps: int) -> dict:
    """Times B1 and B3 (min, all active) on the full operand and on a
    sub-operand holding only the heaviest row block's tile range (rows
    local to that block).  If the block alone takes most of the full
    launch, the launch follows its heaviest row block."""
    import torch
    from repro_torch.core.graph import BBCSR
    from repro_torch.kernels import spmv_dma as K
    b = int(rb_slots.argmax())
    lo, hi = int(bb.rb_ptr[b]), int(bb.rb_ptr[b + 1])
    sub = BBCSR(bb.rows_local[lo:hi], bb.cols_local[lo:hi], bb.vals[lo:hi],
                torch.zeros(hi - lo, dtype=torch.int32, device="cuda"),
                bb.tile_cb[lo:hi].contiguous(),
                bb.tile_init[lo:hi].contiguous(), bb.block_rows, bb.n_cols,
                bb.block_rows, bb.block_cols, bb.tile_nnz,
                tile_cnt=bb.tile_cnt[lo:hi].contiguous(),
                rb_ptr=torch.tensor([0, hi - lo], dtype=torch.int32,
                                    device="cuda"),
                nnz=int(bb.tile_cnt[lo:hi].long().sum()))
    sub_act = all_act[:hi - lo]
    out = dict(
        row_block=b, tiles=hi - lo, real_slots=int(rb_slots[b]),
        spmv_full_ms=cuda_ms(lambda: K.spmv_bbcsr_kernel_call(bb, x), reps),
        spmv_alone_ms=cuda_ms(lambda: K.spmv_bbcsr_kernel_call(sub, x), reps),
        min_full_ms=cuda_ms(lambda: K.spmspv_bbcsr_kernel_call(
            bb, x, all_act, combine="min"), reps),
        min_alone_ms=cuda_ms(lambda: K.spmspv_bbcsr_kernel_call(
            sub, x, sub_act, combine="min"), reps))
    log(f"[time] heaviest row block {b} ({hi - lo} tiles, "
        f"{out['real_slots']} real slots): B1 full {out['spmv_full_ms']!r} "
        f"ms, block alone {out['spmv_alone_ms']!r} ms; B3 min all-active "
        f"full {out['min_full_ms']!r} ms, block alone "
        f"{out['min_alone_ms']!r} ms")
    return out


def masked_attention(q, k, v, mask):
    """The plain attention of ``ref.flash_attention_ref`` under an explicit
    (Sq, Skv) mask (True where the key takes part), in q.dtype: builds the
    B6 check's planted fault."""
    import torch
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    mask = mask.repeat(g, 1)
    out = torch.empty_like(q)
    for b in range(B):
        logits = torch.matmul(q[b].reshape(Hkv, g * Sq, D).float(),
                              k[b].float().transpose(1, 2)) * D ** -0.5
        logits.masked_fill_(~mask, float("-inf"))
        p = torch.softmax(logits, dim=-1).nan_to_num_(nan=0.0)
        out[b] = torch.matmul(p, v[b].float()).reshape(Hq, Sq, D).to(q.dtype)
    return out


def ops_phase(args, seg, n_vertices: int, err: dict) -> dict:
    """Phase 6: the kernel entry point at the configs' widths.  Returns,
    per kernel, its launches in the checked calls and its timings; writes
    each kernel's largest |kernel - plain| into ``err``."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import segment_sum as SS

    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = {}

    def called(mod, key, fn):
        """fn() with mod's launch count zeroed just before and read just
        after; fails unless the kernel launched."""
        mod.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        count = mod.LAUNCHES[key]
        if count == 0:
            fail(f"{key}: the entry point did not launch its kernel")
        return out, count

    def shaped(label, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"{label}: shape {tuple(got.shape)} (want "
                 f"{tuple(want.shape)}) or non-finite values")

    def held(entry, label, got, want, tol):
        """got within rtol tol and atol tol of want; returns the largest
        |got - want|."""
        shaped(label, got, want)
        d = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=tol, atol=tol))
        log(f"[ops] {label}: max |kernel - plain| = {d!r} (rtol/atol {tol}); "
            f"max |plain| {float(want.abs().max())!r}")
        if not ok:
            fail(f"{label}: kernel disagrees with the plain version")
        err[entry] = max(err.get(entry, 0.0), d)
        return d

    def attention_reading(got, want):
        """(largest per-row ||got - want|| / ||want||, largest element's
        |got - want| over its limit): got passes iff the first is at most
        ATTN_ROW_TOL and the second at most 1."""
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        row = diff.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
        rms = want.pow(2).mean(-1, keepdim=True).sqrt()
        limit = ATTN_TOL * (want.abs() + rms.clamp(max=1.0))
        return (float(row.max()),
                float((diff / limit.clamp_min(1e-30)).max()))

    def held_attention(label, got, want, faulty):
        """The B6 check on the kernel, and on a planted fault, which must
        fail it.  Returns the kernel's largest |kernel - plain|, and the
        kernel's and the fault's largest per-row relative error."""
        shaped(label, got, want)
        k_row, k_el = attention_reading(got, want)
        f_row, f_el = attention_reading(faulty, want)
        d = float((got.float() - want.float()).abs().max())
        log(f"[ops] {label}: max |kernel - plain| = {d!r}; per row max "
            f"||kernel - plain|| / ||plain|| = {k_row!r} (limit "
            f"{ATTN_ROW_TOL}), element max {k_el!r} of its limit; planted "
            f"fault: row {f_row!r}, element {f_el!r} of its limit")
        if k_row > ATTN_ROW_TOL or k_el > 1.0:
            fail(f"{label}: kernel disagrees with the plain version")
        if f_row <= ATTN_ROW_TOL and f_el <= 1.0:
            fail(f"{label}: the planted fault passes the check")
        err["flash_attention"] = max(err.get("flash_attention", 0.0), d)
        return d, k_row, f_row

    # -- B4: gin-tu's sum aggregation over RMAT in-edges ---------------------
    d_hidden = 64                         # configs/gin_tu.py d_hidden
    n_e = seg.numel()
    data = torch.randn(n_e, d_hidden, device="cuda", generator=gen)
    out, cnt = called(SS, "segment_sum", lambda: ops.segment_sum_sorted(
        data, seg, n_vertices))
    held("segment_sum", f"B4 segment_sum ({n_e}, {d_hidden}) -> "
         f"({n_vertices}, {d_hidden})", out,
         ref.segment_sum_ref(data, seg, n_vertices), SEG_TOL)
    del out
    lib_out = torch.zeros(n_vertices, d_hidden, device="cuda")
    rows["segment_sum"] = dict(
        launches=cnt,
        ms=cuda_ms(lambda: ops.segment_sum_sorted(data, seg, n_vertices),
                   args.reps),
        plain_ms=cuda_ms(lambda: ref.segment_sum_ref(data, seg, n_vertices),
                         3, 1),
        # data and seg read once, out written once
        bound_ms=1e3 * (4 * n_e * d_hidden + 4 * n_e
                        + 4 * n_vertices * d_hidden) / HBM_BYTES_PER_S,
        bound_by="bytes",
        library_ms=cuda_ms(lambda: lib_out.index_add_(0, seg, data),
                           args.reps))
    del data, lib_out, seg
    torch.cuda.empty_cache()

    # -- B5: fm serving, bulk and p99 batches -------------------------------
    n_fields, per_field, emb = 39, 1_000_000, 10      # configs/fm.py
    batch = 262_144                       # configs/common.py serve_bulk
    batch_p99 = 512                       # configs/common.py serve_p99
    v_rows = -(-n_fields * per_field // 512) * 512
    d = 1 + emb                           # linear + latent, one table
    table = torch.randn(v_rows, d, device="cuda", generator=gen)
    # ids as data/synthetic.py draws them: Zipf(1.2) per field, plus the
    # field's offset; each sample is one bag of its 39 lookups
    rng = np.random.default_rng(12)

    def fm_stream(n_samples):
        local = rng.zipf(1.2, size=(n_samples, n_fields)) % per_field
        ids = (local + np.arange(n_fields)[None, :] * per_field).astype(
            np.int32)
        return (torch.from_numpy(ids.reshape(-1)).cuda(),
                torch.arange(n_samples, dtype=torch.int32, device="cuda"
                             ).repeat_interleave(n_fields))

    idx, bag = fm_stream(batch)
    n_look = idx.numel()
    out, cnt = called(EB, "embedding_bag", lambda: ops.embedding_bag(
        table, idx, bag, batch))
    err_sum = held("embedding_bag", f"B5 embedding_bag sum ({n_look} "
                   f"lookups, {batch} bags, d {d})", out,
                   ref.embedding_bag_ref(table, idx, bag, batch), BAG_TOL)
    idx_pad = torch.where(torch.rand(n_look, device="cuda", generator=gen)
                          < 0.1, -1, idx)
    w = torch.rand(n_look, device="cuda", generator=gen)
    out_m, cnt_m = called(EB, "embedding_bag", lambda: ops.embedding_bag(
        table, idx_pad, bag, batch, w, "mean"))
    err_mean = held(
        "embedding_bag", "B5 embedding_bag weighted mean, 10% ids -1", out_m,
        ref.embedding_bag_ref(table, idx_pad, bag, batch, w, "mean"), BAG_TOL)
    idx_p99, bag_p99 = fm_stream(batch_p99)
    out_p, cnt_p = called(EB, "embedding_bag", lambda: ops.embedding_bag(
        table, idx_p99, bag_p99, batch_p99))
    err_p99 = held("embedding_bag", f"B5 embedding_bag serve_p99 sum "
                   f"({idx_p99.numel()} lookups, {batch_p99} bags)", out_p,
                   ref.embedding_bag_ref(table, idx_p99, bag_p99, batch_p99),
                   BAG_TOL)
    del out, out_m, out_p

    def bag_bytes(ix, n_bags, weighted):
        """(bytes of idx and bag read once, the weights too, and out written
        once; bytes of the distinct valid rows; those rows' bytes in the
        32-byte sectors they span; the number of those rows)."""
        rows_read = torch.unique(ix[ix >= 0]).long()
        first = rows_read * (4 * d) // 32
        last = (rows_read * (4 * d) + 4 * d - 1) // 32
        n = ix.numel()
        return (4 * n * (3 if weighted else 2) + 4 * n_bags * d,
                4 * d * rows_read.numel(),
                32 * int((last - first + 1).sum()), rows_read.numel())

    def library(ix, bg, n_bags):
        off = torch.searchsorted(bg, torch.arange(n_bags, dtype=bg.dtype,
                                                  device="cuda"))
        ix64 = ix.long()
        return lambda: F.embedding_bag(ix64, table, off, mode="sum")

    cases = []
    for label, ix, bg, n_bags, wt, mode, launched, d_err in (
            ("fm serve_bulk sum", idx, bag, batch, None, "sum", cnt,
             err_sum),
            ("fm serve_bulk weighted mean, 10% ids -1", idx_pad, bag, batch,
             w, "mean", cnt_m, err_mean),
            ("fm serve_p99 sum", idx_p99, bag_p99, batch_p99, None, "sum",
             cnt_p, err_p99)):
        stream_b, row_b, sector_b, n_distinct = bag_bytes(
            ix, n_bags, wt is not None)
        case = dict(
            case=label, n_lookups=ix.numel(), n_bags=n_bags, d=d,
            launches=launched, max_abs_err=d_err,
            # the kernel wrapper on the bag-sorted stream (the entry point's
            # sentinels and sort are glue, timed apart below)
            ms=cuda_ms(lambda: EB.embedding_bag_kernel_call(
                table, ix, bg, n_bags, wt, mode=mode), args.reps),
            plain_ms=cuda_ms(lambda: ref.embedding_bag_ref(
                table, ix, bg, n_bags, wt, mode), 3, 1),
            bound_ms=1e3 * (stream_b + row_b) / HBM_BYTES_PER_S,
            bound_by="bytes",
            # F.embedding_bag takes per-sample weights only for 'sum', and
            # no -1 ids: the weighted mean has no single library call
            library_ms=None if wt is not None else cuda_ms(
                library(ix, bg, n_bags), args.reps))
        log(f"[time] embedding_bag {label}: kernel {case['ms']!r} ms, plain "
            f"{case['plain_ms']!r} ms, bound {case['bound_ms']!r} ms, "
            f"library {case['library_ms']!r} ms")
        log(f"[ops] B5 {label}: {n_distinct} distinct rows of {v_rows}: "
            f"{row_b} B as rows, {sector_b} B in the 32-byte sectors they "
            f"span; byte bound {case['bound_ms']!r} ms, "
            f"{1e3 * (stream_b + sector_b) / HBM_BYTES_PER_S!r} ms counting "
            f"the rows' sectors (information only, no limit uses it)")
        cases.append(case)
    entry_ms = cuda_ms(lambda: ops.embedding_bag(table, idx, bag, batch), 5)
    log(f"[ops] B5: entry point with its sort {entry_ms!r} ms")
    # B5's times are the bulk sum's; its launches cover all three checked
    # calls
    rows["embedding_bag"] = dict(
        launches=sum(c["launches"] for c in cases),
        **{key: cases[0][key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
        cases=cases)
    del table, idx, bag, idx_pad, w, idx_p99, bag_p99
    torch.cuda.empty_cache()

    # -- B6: qwen3-14b prefill and decode, mixtral-8x7b window ---------------
    cases = []
    shapes = [  # label, B, Hq, Hkv, Sq, Skv, window, the path it must take
        ("qwen3-14b prefill", 1, 40, 8, 4096, 4096, None, "wgmma"),
        ("qwen3-14b decode", 128, 40, 8, 1, 32768, None, "mma"),
        ("mixtral-8x7b window", 1, 32, 8, 8192, 8192, 4096, "wgmma"),
        ("qwen3-14b decode batch 1", 1, 40, 8, 1, 32768, None, "mma split")]
    D = 128
    for label, B, Hq, Hkv, Sq, Skv, window, want_path in shapes:
        q = torch.randn(B, Hq, Sq, D, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        k = torch.randn(B, Hkv, Skv, D, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        v = torch.randn(B, Hkv, Skv, D, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        out, cnt = called(FA, "flash_attention", lambda: ops.flash_attention(
            q, k, v, causal=True, window=window))
        # the path the per-path counts say the call took
        took = "wgmma" if FA.LAUNCHES["flash_attention_wgmma"] else \
            "mma split" if FA.LAUNCHES["flash_attention_split"] else "mma"
        if took != want_path:
            fail(f"B6 {label}: took the {took} path, the dispatch rule "
                 f"gives {want_path}")
        visible = ref.attention_mask(Sq, Skv, True, window, "cuda")
        # the planted fault: each row's own key block left out
        qpos = torch.arange(Sq, device="cuda")[:, None] + (Skv - Sq)
        kpos = torch.arange(Skv, device="cuda")[None, :]
        faulty = masked_attention(
            q, k, v, visible & (kpos // FAULT_BLOCK != qpos // FAULT_BLOCK))
        d, row, row_fault = held_attention(
            f"B6 {label} B{B} Hq{Hq} Hkv{Hkv} Sq{Sq} Skv{Skv} window "
            f"{window}", out,
            ref.flash_attention_ref(q, k, v, causal=True, window=window),
            faulty)
        del out, faulty, qpos, kpos
        # operations on the visible (query, key) pairs only, 4 D each
        by_ops = 4 * D * B * Hq * int(visible.sum()) / BF16_FLOP_PER_S
        by_bytes = 2 * (2 * q.numel() + 2 * k.numel()) / HBM_BYTES_PER_S
        # prefill: is_causal (Sq == Skv, so both alignments agree); decode:
        # Sq = 1 at the last position sees every key, so no mask; window: an
        # explicit band, in torch's convention (True where the key takes
        # part)
        band = None if window is None else visible

        def lib():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=band, is_causal=band is None and Sq > 1,
                enable_gqa=True)
        case = dict(
            shape=label, B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Skv=Skv, window=window,
            path=took, launches=cnt, max_abs_err=d, row_err=row,
            row_err_fault=row_fault,
            ms=cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                   window=window), args.reps),
            plain_ms=cuda_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=True, window=window), 3, 1),
            bound_ms=1e3 * max(by_ops, by_bytes),
            bound_by="operations" if by_ops >= by_bytes else "bytes",
            library_ms=cuda_ms(lib, args.reps))
        log(f"[time] flash_attention {label} ({took}): kernel "
            f"{case['ms']!r} ms, plain {case['plain_ms']!r} ms, bound "
            f"{case['bound_ms']!r} ms "
            f"({case['bound_by']}), library {case['library_ms']!r} ms")
        cases.append(case)
        del q, k, v, band, visible
        torch.cuda.empty_cache()

    # B6's times are those of the shape furthest from its bound, named in
    # "shape"; its launches cover all four checked calls
    worst = max(cases, key=lambda c: c["ms"] / c["bound_ms"])
    rows["flash_attention"] = dict(
        launches=sum(c["launches"] for c in cases), shape=worst["shape"],
        **{key: worst[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
        cases=cases)
    for k in ("segment_sum", "embedding_bag"):
        t = rows[k]
        log(f"[time] {k}: kernel {t['ms']!r} ms, plain {t['plain_ms']!r} "
            f"ms, bound {t['bound_ms']!r} ms, library {t['library_ms']!r} "
            f"ms")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "chip_smoke.json"),
                    help="where to write the run's numbers as JSON")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a card")
    from repro_torch.core import engine, rmat
    from repro_torch.core.algorithms import (bfs, connected_components,
                                             pagerank, spmv, spmv_bbcsr, sssp,
                                             sssp_program, auto_delta)
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import spmv_dma as K

    t_all = time.perf_counter()
    # -- 1. device -----------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} sm_{cap[0]}{cap[1]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")

    # -- 2. build: one nvcc per source, all started together -----------------
    t0 = time.perf_counter()
    built = _build.compile_all()
    log(f"[build] {len(built)} sources in {time.perf_counter() - t0:.2f} s")
    for lib_path, ptxas in built.values():
        log(f"[build] {lib_path.name}")
        for line in ptxas.splitlines():
            if "registers" in line or "Compiling entry" in line or \
                    "spill" in line:
                log(f"[build]   {line.strip()}")

    # -- graph ---------------------------------------------------------------
    t0 = time.perf_counter()
    g = rmat(args.scale, 16, seed=7)
    torch.cuda.synchronize()
    n = g.n_rows
    log(f"[graph] rmat({args.scale}, 16, seed=7): n={n} nnz={g.nnz} "
        f"in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    bb = engine.build_pull_operand(g)
    torch.cuda.synchronize()
    real = int(bb.tile_cnt.long().sum())
    log(f"[graph] pull operand {bb.block_rows}/{bb.block_cols}/{bb.tile_nnz}:"
        f" {bb.n_tiles} tiles, {real} real slots "
        f"({bb.n_tiles * bb.tile_nnz / max(real, 1):.1f} slots per nonzero) "
        f"in {time.perf_counter() - t0:.2f} s")

    rb_slots = torch.zeros(bb.n_row_blocks, dtype=torch.int64, device="cuda")
    rb_slots.index_add_(0, bb.tile_rb.long(), bb.tile_cnt.long())
    rb_tiles = (bb.rb_ptr[1:] - bb.rb_ptr[:-1]).long()
    log(f"[graph] per row block: real slots max {int(rb_slots.max())} mean "
        f"{float(rb_slots.double().mean())!r}; tiles max "
        f"{int(rb_tiles.max())} mean {float(rb_tiles.double().mean())!r}")

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand(n, device="cuda", generator=gen)
    # B2/B3 sparse frontier: 8 vertices in each of ~1% of the column blocks
    n_cb = bb.n_col_blocks
    blocks = torch.randperm(n_cb, device="cuda", generator=gen)[
        :max(1, n_cb // 100)]
    offs = torch.randint(0, bb.block_cols, (blocks.numel(), 8), device="cuda",
                         generator=gen)
    ids = (blocks[:, None] * bb.block_cols + offs).reshape(-1)
    ids = ids[ids < n]
    frontier = torch.zeros(n, dtype=torch.int32, device="cuda")
    frontier[ids] = 1
    act = engine.tile_active(bb, frontier)
    all_act = torch.ones(bb.n_tiles, dtype=torch.int32, device="cuda")
    x_sp = torch.where(frontier > 0, x, 0.0)
    x_min = torch.where(frontier > 0, x, float("inf"))
    x_max = torch.where(frontier > 0, x, float("-inf"))
    log(f"[graph] sparse frontier: {ids.numel()} vertices, "
        f"{int((act != 0).sum())}/{bb.n_tiles} tiles active")

    # -- 3. kernel parity ----------------------------------------------------
    err = {}

    def check(entry, label, got, want, exact):
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        fin = torch.isfinite(want)
        if not torch.equal(torch.isfinite(got), fin) or \
                not torch.equal(got[~fin], want[~fin]):
            fail(f"{label}: non-finite entries differ")
        d = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
        if exact:
            ok = torch.equal(got, want)
        else:
            ok = bool(torch.allclose(got, want, rtol=ADD_RTOL, atol=ADD_ATOL))
        log(f"[parity] {label}: max |kernel - plain| = {d!r} "
            f"({'exact' if exact else f'rtol {ADD_RTOL} atol {ADD_ATOL}'})")
        if not ok:
            fail(f"{label}: kernel disagrees with the plain version")
        err[entry] = max(err.get(entry, 0.0), d)

    K.reset_launches()
    check("spmv_bbcsr", "B1 spmv add", K.spmv_bbcsr_kernel_call(bb, x),
          ref.spmv_bbcsr_ref(bb, x), False)
    check("spmspv_bbcsr_add", "B2 spmspv add 1% blocks",
          K.spmspv_bbcsr_kernel_call(bb, x_sp, act),
          ref.spmspv_bbcsr_ref(bb, x_sp, act), False)
    for comb, xs in (("min", x_min), ("max", x_max)):
        check("spmspv_bbcsr_select", f"B3 spmspv {comb} all-active",
              K.spmspv_bbcsr_kernel_call(bb, x, all_act, combine=comb),
              ref.spmspv_bbcsr_ref(bb, x, all_act, combine=comb), True)
        check("spmspv_bbcsr_select", f"B3 spmspv {comb} sparse",
              K.spmspv_bbcsr_kernel_call(bb, xs, act, combine=comb),
              ref.spmspv_bbcsr_ref(bb, xs, act, combine=comb), True)

    # the 'add' kernels sum in a fixed order: two launches, equal bits
    for label, fn in (
            ("B1 spmv", lambda: K.spmv_bbcsr_kernel_call(bb, x)),
            ("B2 spmspv add", lambda: K.spmspv_bbcsr_kernel_call(
                bb, x_sp, act))):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        same = torch.equal(first, second)
        log(f"[repro] {label}: two launches bit-equal: {same}")
        if not same:
            fail(f"{label}: two launches on the same inputs differ")
        del first, second

    # -- 5. timings (on the weighted operand, before it is freed) -------------
    t_a = g.transpose()
    lib_mat = torch.sparse_csr_tensor(t_a.indptr, t_a.indices, t_a.values,
                                      size=(n, n))
    timed = {
        "spmv_bbcsr": dict(
            ms=cuda_ms(lambda: K.spmv_bbcsr_kernel_call(bb, x), args.reps),
            plain_ms=cuda_ms(lambda: ref.spmv_bbcsr_ref(bb, x), 3, 1),
            bound_ms=bound_ms(bb),
            library_ms=cuda_ms(lambda: torch.mv(lib_mat, x), args.reps)),
        "spmspv_bbcsr_add": dict(
            ms=cuda_ms(lambda: K.spmspv_bbcsr_kernel_call(bb, x_sp, act),
                       args.reps),
            plain_ms=cuda_ms(lambda: ref.spmspv_bbcsr_ref(bb, x_sp, act), 3,
                             1),
            bound_ms=bound_ms(bb, act),
            # x_sp is zero off the frontier, so A @ x_sp is the same function
            library_ms=cuda_ms(lambda: torch.mv(lib_mat, x_sp), args.reps)),
        "spmspv_bbcsr_select": dict(
            ms=cuda_ms(lambda: K.spmspv_bbcsr_kernel_call(
                bb, x, all_act, combine="min"), args.reps),
            plain_ms=cuda_ms(lambda: ref.spmspv_bbcsr_ref(
                bb, x, all_act, combine="min"), 3, 1),
            bound_ms=bound_ms(bb, all_act),
            library_ms=None),
    }
    sparse_min_ms = cuda_ms(lambda: K.spmspv_bbcsr_kernel_call(
        bb, x_min, act, combine="min"), args.reps)
    for entry, t in timed.items():
        log(f"[time] {entry}: kernel {t['ms']!r} ms, plain {t['plain_ms']!r} "
            f"ms, bound {t['bound_ms']!r} ms, library {t['library_ms']!r} ms")
    log(f"[time] spmspv_bbcsr_select min sparse: kernel {sparse_min_ms!r} ms,"
        f" bound {bound_ms(bb, act)!r} ms")
    heavy = heaviest_block_diagnostic(bb, rb_slots, x, all_act, args.reps)
    del lib_mat

    # -- 4. main path ----------------------------------------------------------
    launches = dict.fromkeys(K.LAUNCHES, 0)
    walls, path_launches = {}, {}

    def path(label, fn):
        """Run one query with the launch counts zeroed before it and read
        after it, then once more for a warm wall time (not counted)."""
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        path_launches[label] = dict(K.LAUNCHES)
        for k, v in K.LAUNCHES.items():
            launches[k] += v
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[label] = (cold, time.perf_counter() - t0)
        log(f"[path] {label}: {cold!r} s cold, {walls[label][1]!r} s warm; "
            f"launches {path_launches[label]}")
        return out

    torch.cuda.reset_peak_memory_stats()
    y_k = path("spmv_bbcsr", lambda: spmv_bbcsr(bb, x))
    # the pull operand holds A^T: the plain SpMV runs on the same matrix
    y_p = path("spmv (plain)", lambda: spmv(t_a, x))
    if not torch.allclose(y_k, y_p, rtol=1e-4, atol=1e-4):
        fail("spmv_bbcsr disagrees with spmv beyond rtol/atol 1e-4")
    log(f"[check] spmv_bbcsr vs spmv: max diff "
        f"{float((y_k - y_p).abs().max())!r} (rtol/atol 1e-4)")
    del bb, t_a, y_k, y_p
    torch.cuda.empty_cache()

    bb_u = engine.build_pull_operand(g, unit_values=True)
    lv_k = path("bfs kernel_bb", lambda: bfs(g, 0, kernel_bb=bb_u))
    del bb_u
    torch.cuda.empty_cache()
    lv_p = path("bfs (plain)", lambda: bfs(g, 0))
    if not torch.equal(lv_k, lv_p):
        fail("BFS levels differ between the kernel path and the plain path")
    bfs_reached = int((lv_p >= 0).sum())
    # on the kernel path a pull level is one SpMV launch, a push level one
    # SpMSpV launch
    log(f"[check] bfs levels bit-equal; reached {bfs_reached}, depth "
        f"{int(lv_p.max())}; kernel path pulls "
        f"{path_launches['bfs kernel_bb']['spmv_bbcsr']} pushes "
        f"{path_launches['bfs kernel_bb']['spmspv_bbcsr_add']}")

    delta = auto_delta(g)
    bb_m = engine.build_pull_operand(g, combine="min")

    def sssp_kernel():
        dist0 = torch.full((n,), float("inf"), device="cuda")
        dist0[0] = 0.0
        pend0 = torch.zeros(n, dtype=torch.bool, device="cuda")
        pend0[0] = True
        f0 = torch.zeros(n, dtype=torch.int32, device="cuda")
        f0[0] = 1
        state0 = {"dist": dist0, "pending": pend0,
                  "bound": torch.tensor(delta, device="cuda")}
        return engine.run(g, sssp_program(delta), state0, f0,
                          max_iters=4 * n, kernel_bb=bb_m, return_stats=True)

    st_k, stats_k = path("sssp kernel_bb", sssp_kernel)
    del bb_m
    torch.cuda.empty_cache()
    d_p, stats_p = path("sssp (plain)",
                        lambda: sssp(g, 0, delta=delta, return_stats=True))
    if not torch.equal(st_k["dist"], d_p):
        fail("SSSP distances differ between the kernel path and the plain "
             "path")
    sssp_reached = int(torch.isfinite(d_p).sum())
    log(f"[check] sssp distances bit-equal (delta {delta!r}); stats kernel "
        f"{stats_k} plain {stats_p}")
    log(f"[check] bfs reached == sssp reached: {bfs_reached} == "
        f"{sssp_reached}: {bfs_reached == sssp_reached}")
    if bfs_reached != sssp_reached:
        fail("BFS and SSSP reach different vertex sets")

    pr = path("pagerank", lambda: pagerank(g))
    mass = float(pr.double().sum())
    log(f"[check] pagerank mass {mass!r}")
    if not (torch.isfinite(pr).all() and abs(mass - 1.0) <= 1e-3):
        fail(f"pagerank mass {mass} is not 1 within 1e-3")

    labels, cc_stats = path("connected_components", lambda:
                            connected_components(g, return_stats=True))
    roots = labels[labels.long()]
    n_comp = int((labels == torch.arange(n, device="cuda")).sum())
    if not (torch.equal(roots, labels)
            and bool((labels <= torch.arange(n, device="cuda")).all())
            and bool((labels[lv_p >= 0] == labels[0]).all())):
        fail("connected-component labels are not min-member roots that "
             "cover the BFS tree of vertex 0")
    log(f"[check] cc: {n_comp} components, stats {cc_stats}")
    log(f"[mem] peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    for k in ("spmv_bbcsr", "spmspv_bbcsr_add", "spmspv_bbcsr_select"):
        if launches[k] == 0:
            fail(f"kernel {k} was not launched on the main path")
        timed[k]["bound_by"] = "bytes"

    # the graph path's operands are gone; phase 6 needs only the edge ids
    seg = g.transpose().row_ids()
    del g, labels, roots, pr, lv_k, lv_p, st_k, d_p
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops_rows = ops_phase(args, seg, n, err)
    log(f"[mem] phase 6 peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    timed.update(ops_rows)
    for k, t in ops_rows.items():
        launches[k] = t.pop("launches")

    kernels = [dict(name=k, route="cuda", source=SOURCE[k],
                    replaces=REPLACES[k], launches=launches[k],
                    max_abs_err=err[k], ms=timed[k]["ms"],
                    plain_ms=timed[k]["plain_ms"],
                    bound_ms=timed[k]["bound_ms"],
                    bound_by=timed[k]["bound_by"],
                    library_ms=timed[k]["library_ms"],
                    **{key: timed[k][key] for key in ("shape", "cases")
                       if key in timed[k]})
               for k in SOURCE]
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"device": name, "nvidia_smi": smi, "scale": args.scale,
                   "kernels": kernels, "walls_s": walls,
                   "sparse_min_ms": sparse_min_ms, "heaviest_block": heavy,
                   "total_s": time.perf_counter() - t_all}, fh, indent=1)
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
