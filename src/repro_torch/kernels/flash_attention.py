"""Flash attention forward: torch wrapper of the CUDA kernels in
``csrc/flash_attention.cu``.

Counterpart of ``repro.kernels.flash_attention``: GQA (query head h reads
kv head h // g), a causal mask that puts the queries at the last Sq of the
Skv positions, an optional sliding window (key j visible to position p iff
p - window < j <= p).  Given CPU tensors the wrapper computes the plain
version (:func:`.ref.flash_attention_ref`); given CUDA tensors it launches
a kernel or raises.

The rule that picks the kernel of a call on the card (:func:`path`), from
its dtype, head dim D and query length Sq:

- ``"wgmma"``: bf16 with D = 128 and Sq >= :data:`WGMMA_MIN_SQ`.  TMA and
  wgmma, one CTA per (batch, query head, :data:`WGMMA_TILE` query
  positions), blocks of :data:`WGMMA_TILE` keys; block_q and block_k do not
  apply.  Prefill and sliding-window calls.  Below the threshold a tile
  would be less than half full, and the folded kernel, which serves the g
  query heads of a kv head from one read of k and v, wastes less.
- ``"mma"``: every other bf16 call (decode, short Sq, D < 128).  mma.sync
  over the folded (query position, group head) rows, block_q rows and
  block_k keys per tile.
- ``"simt"``: f32, plain FMA (no TF32), the same folded tiles.

On the two folded paths :func:`split_plan` decides, from the number of
(batch, kv head, row tile) CTAs, their visible key blocks and the card's SM
count, into how many contiguous pieces each row tile's keys are cut; with
more than one, each piece writes its (m, l, acc) to f32 scratch and a second
kernel merges the pieces in split order (bit-reproducible).

Each entry call on the card adds one to ``LAUNCHES["flash_attention"]``; a
call on the wgmma path also adds one to ``LAUNCHES["flash_attention_wgmma"]``
and a call whose keys were split (splits > 1) one to
``LAUNCHES["flash_attention_split"]``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from . import ref

__all__ = ["flash_attention_kernel_call", "LAUNCHES", "reset_launches",
           "HEAD_DIMS", "BLOCK_Q", "BLOCK_K", "WGMMA_TILE", "WGMMA_MIN_SQ",
           "MIN_SPLIT_BLOCKS", "path", "key_blocks", "split_range",
           "split_plan", "tile_order", "kv_rows"]

# kernel launches since the last reset_launches(): every entry call, and
# those that took the wgmma kernel or split their keys
LAUNCHES = {"flash_attention": 0, "flash_attention_wgmma": 0,
            "flash_attention_split": 0}
HEAD_DIMS = (16, 32, 64, 128)     # the folded kernels' template instances
BLOCK_Q = (16, 32, 64, 128)       # folded rows per CTA, 16 per warp
BLOCK_K = (32, 64)                # keys per shared-memory tile (folded)
WGMMA_TILE = 128                  # query positions and keys per wgmma tile
WGMMA_MIN_SQ = WGMMA_TILE // 2    # the wgmma path's shortest Sq
MIN_SPLIT_BLOCKS = 4              # fewest key blocks in a split piece
SPLIT_WAVES = 2                   # the split aims for this many CTAs per SM


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_argtypes_set", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, o, part_acc, part_ml, B, Hq, Hkv, Sq, Skv, kv_rows, D,
        # causal, window, scale, block_q, block_k, splits, bf16, stream
        lib.flash_attention_fwd.argtypes = [P] * 6 + [I] * 9 + [F] + \
            [I] * 4 + [P]
        lib.flash_attention_fwd.restype = ctypes.c_int
        # q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale, stream
        lib.flash_attention_wgmma_fwd.argtypes = [P] * 4 + [I] * 7 + [F, P]
        lib.flash_attention_wgmma_fwd.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def path(dtype: torch.dtype, head_dim: int, sq: int) -> str:
    """The kernel a call on the card takes: "wgmma", "mma" or "simt"."""
    if dtype == torch.float32:
        return "simt"
    if head_dim == WGMMA_TILE and sq >= WGMMA_MIN_SQ:
        return "wgmma"
    return "mma"


def key_blocks(sq: int, skv: int, g: int, r0: int, block_q: int,
               block_k: int, causal: bool, window: Optional[int]):
    """The key blocks [kb0, kb1) that some folded row r0 ... r0 + block_q - 1
    (row r is query position r // g) can see: the folded kernels' key range
    of one row tile (``key_blocks`` in the CUDA source)."""
    off = skv - sq
    r_last = min(r0 + block_q, sq * g) - 1
    p_lo, p_hi = r0 // g + off, r_last // g + off
    hi = min(skv, p_hi + 1) if causal else skv
    lo = max(0, p_lo - window + 1) if window else 0
    kb0 = lo // block_k
    return kb0, (-(-hi // block_k) if hi > lo else kb0)


def split_range(kb0: int, kb1: int, split: int, splits: int):
    """Piece ``split`` of ``splits`` of the key blocks [kb0, kb1): contiguous
    and of balanced length, as the kernels cut them (``split_blocks``)."""
    n = kb1 - kb0
    return kb0 + n * split // splits, kb0 + n * (split + 1) // splits


def split_plan(B: int, hkv: int, sq: int, skv: int, g: int, block_q: int,
               block_k: int, causal: bool, window: Optional[int],
               n_sm: int) -> int:
    """How many pieces the folded kernels cut each row tile's key blocks
    into.  Enough for SPLIT_WAVES CTAs per SM over all (batch, kv head, row
    tile) CTAs, and no more than leaves each piece of the row tile with the
    fewest visible blocks MIN_SPLIT_BLOCKS of them, so no piece is empty.
    Batch-1 decode splits; large batches, and long Sq, do not."""
    tiles = -(-sq * g // block_q)
    ctas = B * hkv * tiles
    if ctas >= SPLIT_WAVES * n_sm:
        return 1
    fewest = min(kb1 - kb0 for kb0, kb1 in (
        key_blocks(sq, skv, g, t * block_q, block_q, block_k, causal, window)
        for t in range(tiles)))
    want = -(-SPLIT_WAVES * n_sm // ctas)
    return max(1, min(want, fewest // MIN_SPLIT_BLOCKS))


def tile_order(n_tiles: int, causal: bool) -> list:
    """The query tile of each launch rank of the wgmma kernel.  Causal: the
    last tile, which sees the most keys, first; else in order (without a
    causal mask a window leaves the first tiles the most keys)."""
    return list(range(n_tiles - 1, -1, -1)) if causal else \
        list(range(n_tiles))


def kv_rows(k: torch.Tensor, v: torch.Tensor) -> Optional[int]:
    """R where k and v (B, Hkv, Skv, D) are the first Skv rows of
    (B, Hkv, R, D) blocks on 16-byte boundaries, as a slice of a decode
    cache is, so the folded kernels read them in place; None where they
    must be made contiguous first."""
    B, Hkv, Skv, D = k.shape
    st = k.stride()
    if v.stride() != st or st[3] != 1 or st[2] != D or st[1] % D or \
            (B > 1 and st[0] != Hkv * st[1]) or \
            k.data_ptr() % 16 or v.data_ptr() % 16:
        return None
    return st[1] // D if st[1] // D >= Skv else None


def _check_rows_see_keys(sq: int, skv: int, causal: bool,
                         window: Optional[int]) -> None:
    """Raise ValueError when some query row would see no key: there the TPU
    kernel (which averages v) and its oracle (which gives 0) disagree.
    That happens exactly when causal and Sq > Skv, or window < 1."""
    if window is not None and window < 1:
        raise ValueError(f"window={window} leaves every query row without "
                         f"a visible key")
    if causal and sq > skv:
        raise ValueError(f"causal attention with Sq={sq} > Skv={skv} leaves "
                         f"the first {sq - skv} query rows without a key")
    if skv < 1 and sq > 0:
        raise ValueError("Skv=0: no key to attend to")


def flash_attention_kernel_call(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True,
                                window: Optional[int] = None,
                                scale: Optional[float] = None,
                                block_q: int, block_k: int) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D), Hq a multiple of Hkv; the
    folded paths read k and v in place where :func:`kv_rows` allows.
    Returns (B, Hq, Sq, D) in q.dtype.  On the card: bf16 or f32 (one type
    for all three), D in :data:`HEAD_DIMS`, block_q in :data:`BLOCK_Q`,
    block_k in :data:`BLOCK_K` (the folded paths' tile)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or \
            q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"want q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    _check_rows_see_keys(Sq, Skv, causal, window)
    if _build.on_cpu((q, k, v), "flash_attention"):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    if not (q.dtype == k.dtype == v.dtype) or \
            q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernel takes bf16 or f32 q, k, v of one type, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    if block_q not in BLOCK_Q or block_k not in BLOCK_K:
        raise ValueError(f"block_q must be one of {BLOCK_Q} and block_k one "
                         f"of {BLOCK_K}, got {block_q}, {block_k}")
    g = Hq // Hkv
    if max(B, Hkv) > 65535 or Sq * g >= 2 ** 31 or \
            B * Hq * -(-Sq // WGMMA_TILE) >= 2 ** 31:
        raise ValueError(f"shape {tuple(q.shape)} / {tuple(k.shape)} "
                         f"exceeds the kernel's grid")
    # cp.async and TMA move 16-byte chunks: contiguous and aligned, but for
    # the folded kernels' k and v rows, which may lie in a larger cache
    which = path(q.dtype, D, Sq)
    rows = None if which == "wgmma" else kv_rows(k, v)
    if rows is None:
        k, v = (t.contiguous() for t in (k, v))
        k, v = (t.clone() if t.data_ptr() % 16 else t for t in (k, v))
        rows = Skv
    q = q.contiguous()
    q = q.clone() if q.data_ptr() % 16 else q
    out = torch.empty_like(q)
    scale = scale if scale is not None else D ** -0.5
    # a window of Skv or more hides nothing (positions are below Skv)
    window = None if window is None else min(int(window), Skv)
    lib = _lib()
    if which == "wgmma":
        _build.launch(lib.flash_attention_wgmma_fwd, q.device, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv,
                      Sq, Skv, int(causal), window or 0, float(scale),
                      what="flash_attention")
        LAUNCHES["flash_attention_wgmma"] += 1
    else:
        index = q.device.index if q.device.index is not None else \
            torch.cuda.current_device()
        splits = split_plan(B, Hkv, Sq, Skv, g, block_q, block_k, causal,
                            window, _sm_count(index))
        part_acc = part_ml = None
        if splits > 1:
            part_acc = torch.empty((B, Hkv, Sq * g, splits, D),
                                   dtype=torch.float32, device=q.device)
            part_ml = torch.empty((B, Hkv, Sq * g, splits, 2),
                                  dtype=torch.float32, device=q.device)
        _build.launch(lib.flash_attention_fwd, q.device, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      None if part_acc is None else part_acc.data_ptr(),
                      None if part_ml is None else part_ml.data_ptr(),
                      B, Hq, Hkv, Sq, Skv, rows, D, int(causal), window or 0,
                      float(scale), block_q, block_k, splits,
                      int(q.dtype == torch.bfloat16), what="flash_attention")
        if splits > 1:
            LAUNCHES["flash_attention_split"] += 1
    LAUNCHES["flash_attention"] += 1
    return out
