"""LM transformer family: GQA / MLA / qk-norm / sliding window / RoPE / MoE
(counterpart of ``repro.models.transformer``): forward, serving and
training.

One parameterized stack covers the five LM architectures of the registry
(mistral-large-123b, qwen3-14b, minicpm3-4b, llama4-maverick, mixtral-8x7b).
:class:`Transformer` holds its layers in a ``ModuleList`` where the
reference scans stacked groups: layer ``i`` is the reference's group
``i // moe_period``, sublayer ``sub{i % moe_period}``, and its parameters
keep the reference's names and per-group shapes
(``layers.{i}.attn.wq`` is ``layers/sub{j}/attn/wq[g]``).
:func:`params_from_reference` carries the reference's tree across.

Attention runs in the (B, heads, S, head dim) layout.  Where autograd
records (grad enabled and q, k or v requiring grad: a train step) it runs
:class:`FlashAttention`, the reference's custom-VJP flash attention
(online softmax over ``k_chunk`` key blocks forward, probabilities
recomputed from the saved log-sum-exp backward): B6 is forward-only.
Otherwise its route is fixed by the configuration (:func:`attention_route`):
GQA models call the B6 kernel through ``kernels.ops.flash_attention`` (on
CUDA tensors it launches the kernel or raises, on CPU tensors it computes
the plain version); MLA, whose q / k head dim is not one of B6's and
differs from v's, runs :func:`online_attention`, the forward of
:class:`FlashAttention` (the reference's ``_online_softmax_attn`` over
``k_chunk`` key blocks, so no (Sq, Skv) tensor outlives one block: a 32k
prefill holds (heads, Sq, k_chunk) logits, not (heads, Sq, Sq)), and its
decode the absorbed latent form.  ``prefill`` and ``decode_step``
run under ``inference_mode``.  With ``remat`` a training forward
checkpoints each layer (``torch.utils.checkpoint``, the reference's
``jax.checkpoint(nothing_saveable)``).

Decode keeps one KV cache per layer, (B, Kv, Smax, hd), so a step's B6
call reads the cache's first slots in place, with no transpose or copy;
``cache["len"]`` is one Python int shared by the batch.  The cache is
updated in place.

Over a process mesh (``rules`` from ``make_rules(mesh)``) every rank runs
the same call on the whole batch with its blocks of the parameters, as
their placements lie (``Transformer.placements``, from the reference's
:func:`param_logical_axes`): :class:`_Lay` takes the rows of the rank's
data shard, gathers each weight's FSDP dim, keeps the rank's heads, ff
columns, experts and vocab columns, and reduces each region's partial
sums over ``model``; the MoE dispatches per data shard.  The loss has the
global value and the gradient of the rank's share; prefill and decode
give every rank the whole logits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.graph import resolve_device
from ..distributed import routed
from ..distributed.sharding import MeshRules, make_rules
from ..kernels import ops

__all__ = ["LMConfig", "MoEConfig", "MLAConfig", "Transformer", "init_params",
           "forward", "prefill", "loss_fn", "init_cache", "decode_step",
           "grow_cache", "count_params", "attention_route", "rmsnorm", "rope",
           "rope_tables", "params_from_reference", "cache_from_reference",
           "cache_to_reference", "FlashAttention", "flash_attn",
           "online_attention", "param_logical_axes"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int
    period: int = 1               # every `period`-th layer is MoE (last in group)
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_coef: float = 1e-2


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    rope_head_dim: int
    nope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    window: Optional[int] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rope_theta: float = 1e6
    dtype: torch.dtype = torch.bfloat16
    # training: checkpoint each layer; keys per block of the autograd
    # attention's online softmax
    remat: bool = True
    k_chunk: int = 64
    tie_embeddings: bool = False
    # fuse wq/wk/wv into one matmul and w1/w3 into one (Megatron-style)
    fused_qkv: bool = False

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up so the TP axis divides it (padded logits sliced
        off before the loss); standard embedding-table padding."""
        return self.vocab if self.vocab % 16 == 0 else -(-self.vocab // 256) * 256

    @property
    def moe_period(self) -> int:
        return self.moe.period if self.moe else 1

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.moe_period == 0
        return self.n_layers // self.moe_period


def attention_route(cfg: LMConfig) -> str:
    """"flash" (B6 through ``ops.flash_attention``) or "online"
    (:func:`online_attention`; MLA: a q / k head dim outside B6's and a v
    head dim unlike q's)."""
    return "online" if cfg.mla is not None else "flash"


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _attn_shapes(cfg: LMConfig) -> dict:
    """name -> (shape, fan_in or None for a norm) of one layer's attention."""
    d, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.mla is None:
        if cfg.fused_qkv:
            p = {"wqkv": ((d, (H + 2 * Kv) * hd), d)}
        else:
            p = {"wq": ((d, H * hd), d), "wk": ((d, Kv * hd), d),
                 "wv": ((d, Kv * hd), d)}
        p["wo"] = ((H * hd, d), H * hd)
    else:
        m = cfg.mla
        qd = m.nope_head_dim + m.rope_head_dim
        r = m.kv_lora_rank
        p = {"wq_a": ((d, m.q_lora_rank), d),
             "q_a_norm": ((m.q_lora_rank,), None),
             "wq_b": ((m.q_lora_rank, H * qd), m.q_lora_rank),
             "wkv_a": ((d, r + m.rope_head_dim), d),
             "kv_a_norm": ((r,), None),
             "wk_b": ((r, H * m.nope_head_dim), r),
             "wv_b": ((r, H * m.v_head_dim), r),
             "wo": ((H * m.v_head_dim, d), H * m.v_head_dim)}
    if cfg.qk_norm:
        qk = cfg.head_dim if cfg.mla is None else (
            cfg.mla.nope_head_dim + cfg.mla.rope_head_dim)
        p["q_norm"] = ((qk,), None)
        p["k_norm"] = ((qk,), None)
    return p


def _ffn_shapes(cfg: LMConfig, is_moe: bool) -> dict:
    d = cfg.d_model
    if is_moe:
        m = cfg.moe
        return {"router": ((d, m.n_experts), d),
                "w1": ((m.n_experts, d, m.d_ff), d),
                "w3": ((m.n_experts, d, m.d_ff), d),
                "w2": ((m.n_experts, m.d_ff, d), m.d_ff)}
    if cfg.fused_qkv:
        return {"w13": ((d, 2 * cfg.d_ff), d), "w2": ((cfg.d_ff, d), cfg.d_ff)}
    return {"w1": ((d, cfg.d_ff), d), "w3": ((d, cfg.d_ff), d),
            "w2": ((cfg.d_ff, d), cfg.d_ff)}


def _init(shape, fan_in, dtype, gen, device) -> torch.Tensor:
    """N(0, 1 / fan_in) drawn in f32 and cast (fan_in None: a norm, ones
    in f32).  gen None on the meta device (shapes only)."""
    if fan_in is None:
        return torch.ones(shape, dtype=torch.float32, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.div_(math.sqrt(fan_in)).to(dtype)


def _whole(name, w):
    return w


class Block(nn.Module):
    """One sublayer: ln1, attention, ln2, and a dense MLP or an MoE.
    ``keep(name, tensor)`` (names relative to the block) keeps a drawn
    tensor or this rank's block of it."""

    def __init__(self, cfg: LMConfig, is_moe: bool, gen, device,
                 keep=_whole):
        super().__init__()
        ffn_name = "moe" if is_moe else "mlp"

        def make(name, shape, fan_in, dtype):
            return nn.Parameter(keep(name, _init(shape, fan_in, dtype, gen,
                                                 device)))
        self.ln1 = make("ln1", (cfg.d_model,), None, None)
        self.ln2 = make("ln2", (cfg.d_model,), None, None)
        self.attn = nn.ParameterDict({
            k: make("attn." + k, s, f, cfg.dtype)
            for k, (s, f) in _attn_shapes(cfg).items()})
        ffn = nn.ParameterDict({
            k: make(f"{ffn_name}.{k}", s, f,
                    torch.float32 if k == "router" else cfg.dtype)
            for k, (s, f) in _ffn_shapes(cfg, is_moe).items()})
        setattr(self, ffn_name, ffn)


class Transformer(nn.Module):
    """The LM stack with its parameters, drawn from ``seed`` by a
    ``torch.Generator`` on ``device`` (CUDA unless ``device`` says
    otherwise; a CUDA request without a card raises; ``meta`` gives the
    shapes alone).

    ``shardings`` ({parameter name: ``Placement``}, as
    ``configs.common.param_shardings`` gives them over a mesh): each
    parameter is drawn whole, as on one device, and only this rank's block
    of it is kept, so the blocks are those of the one-device draw and the
    whole model is never held.  The placements stay on the model
    (``placements``): its meshed forward reads its layout from them."""

    def __init__(self, cfg: LMConfig, *, seed: int = 0, device=None,
                 shardings: Optional[dict] = None):
        super().__init__()
        dev = resolve_device(device)
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        self.cfg = cfg
        self.placements = None

        def keeper(prefix):
            if not shardings:
                return _whole

            def keep(name, w):
                pl = shardings.get(prefix + name)
                return w if pl is None else pl.block(w)
            return keep
        P = cfg.moe_period
        self.layers = nn.ModuleList(
            Block(cfg, cfg.moe is not None and i % P == P - 1, gen, dev,
                  keeper(f"layers.{i}."))
            for i in range(cfg.n_layers))
        keep = keeper("")
        self.embed = nn.Parameter(keep("embed", _init(
            (cfg.vocab_padded, cfg.d_model), cfg.d_model, cfg.dtype, gen,
            dev)))
        self.final_norm = nn.Parameter(_init((cfg.d_model,), None, None, gen,
                                             dev))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(keep("lm_head", _init(
                (cfg.d_model, cfg.vocab_padded), cfg.d_model, cfg.dtype, gen,
                dev)))
        if shardings:
            self.placements = dict(shardings)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def forward(self, tokens, rules: Optional[MeshRules] = None):
        return forward(self.cfg, self, tokens, rules)


def init_params(cfg: LMConfig, seed: int = 0, *, device=None,
                shardings: Optional[dict] = None) -> Transformer:
    """The reference's ``init_params``: a :class:`Transformer` whose
    parameters are drawn from ``seed`` (over a mesh: this rank's blocks of
    them, by ``shardings``)."""
    return Transformer(cfg, seed=seed, device=device, shardings=shardings)


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def param_logical_axes(cfg: LMConfig, tp_size: int = 16) -> dict:
    """Logical axes per parameter name (the reference's table without its
    leading stacked-group axis): MoE weights are expert parallel when
    n_experts divides the TP axis, else tensor parallel within each
    expert."""
    if cfg.mla is None:
        attn = ({"wqkv": ("embed", "heads")} if cfg.fused_qkv else
                {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
                 "wv": ("embed", "kv_heads")})
        attn["wo"] = ("heads", "embed")
    else:
        attn = {"wq_a": ("embed", None), "q_a_norm": (None,),
                "wq_b": (None, "heads"), "wkv_a": ("embed", None),
                "kv_a_norm": (None,), "wk_b": (None, "heads"),
                "wv_b": (None, "heads"), "wo": ("heads", "embed")}
    if cfg.qk_norm:
        attn["q_norm"] = (None,)
        attn["k_norm"] = (None,)
    if cfg.moe is not None and cfg.moe.n_experts % tp_size == 0:
        moe = {"router": (None, None), "w1": ("expert", "embed", None),
               "w3": ("expert", "embed", None),
               "w2": ("expert", None, "embed")}
    else:
        moe = {"router": (None, None), "w1": (None, "embed", "ff"),
               "w3": (None, "embed", "ff"), "w2": (None, "ff", "embed")}
    mlp = ({"w13": ("embed", "ff"), "w2": ("ff", "embed")} if cfg.fused_qkv
           else {"w1": ("embed", "ff"), "w3": ("embed", "ff"),
                 "w2": ("ff", "embed")})
    out = {"embed": ("vocab", "embed"), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = ("embed", "vocab")
    P = cfg.moe_period
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        out[pre + "ln1"] = out[pre + "ln2"] = (None,)
        out.update({pre + "attn." + k: a for k, a in attn.items()})
        ffn, name = ((moe, "moe") if cfg.moe is not None and i % P == P - 1
                     else (mlp, "mlp"))
        out.update({pre + name + "." + k: a for k, a in ffn.items()})
    return out


def _to_torch(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: move the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_reference(cfg: LMConfig, tree: dict) -> dict:
    """The reference's parameter tree (numpy leaves; stacked ``(G, ...)``
    under ``layers/sub{j}``) as this module's ``state_dict`` (CPU
    tensors): load it with ``model.load_state_dict``."""
    sd = {k: _to_torch(tree[k]) for k in ("embed", "final_norm", "lm_head")
          if k in tree}
    P = cfg.moe_period
    for i in range(cfg.n_layers):
        g, j = divmod(i, P)
        for part, leaf in tree["layers"][f"sub{j}"].items():
            if isinstance(leaf, dict):
                for name, a in leaf.items():
                    sd[f"layers.{i}.{part}.{name}"] = _to_torch(np.asarray(a)[g])
            else:
                sd[f"layers.{i}.{part}"] = _to_torch(np.asarray(leaf)[g])
    return sd


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) * w in f32, cast back to x's dtype."""
    return F.rms_norm(x.float(), (x.shape[-1],), w, eps).to(x.dtype)


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """(cos, sin) of the rotation angles, (..., S, 1, dim // 2) in f32, for
    positions (..., S): computed once a call and shared by the layers."""
    half = dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions[..., None].float() * freqs                 # (..., S, half)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def _rotate(x: torch.Tensor, tables) -> torch.Tensor:
    cos, sin = tables
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x (..., S, H, hd) rotated over half-split pairs (x[:half] with
    x[half:]); positions (..., S)."""
    return _rotate(x, rope_tables(positions, x.shape[-1], theta))


def _key_blocks(skv: int, k_chunk: int) -> tuple[int, int]:
    """(block, count): the reference's block is the largest divisor of
    Skv that is at most k_chunk."""
    t = min(k_chunk, skv)
    while skv % t:
        t -= 1
    return t, skv // t


def _block_rows(k0: int, k1: int, sq: int, causal: bool,
                window: Optional[int]) -> tuple[int, int]:
    """[a, b): the query positions that see at least one key of [k0, k1)
    (query p sees key j when j <= p if causal, and j > p - window)."""
    a = k0 if causal else 0
    b = sq if window is None else min(sq, k1 - 1 + window)
    return a, max(a, b)


def _masked_rows(a: int, r: int, k0: int, t: int, causal: bool,
                 window: Optional[int]) -> list:
    """[lo, hi) ranges of the r query rows at positions a.. that a mask
    hides one of the keys k0..k0 + t - 1 from (causal: rows before the
    block's last key; window: rows at or past k0 + window); every other
    row sees the whole block."""
    spans = []
    if causal and k0 + t - 1 - a > 0:
        spans.append((0, min(r, k0 + t - 1 - a)))
    if window is not None and k0 + window - a < r:
        spans.append((max(0, k0 + window - a), r))
    if len(spans) == 2 and spans[1][0] <= spans[0][1]:
        spans = [(0, r)]
    return spans


def _block_logits(qs, kb, a: int, k0: int, scale: float, causal: bool,
                  window: Optional[int]):
    """Scaled logits of the query rows qs (B, Kv, G, r, D), positions a to
    a + r - 1, against the key block kb (B, Kv, t, D) starting at key k0,
    in f32, -1e30 where masked (the mask built for the rows it hides a key
    from alone, :func:`_masked_rows`)."""
    s = torch.matmul(qs, kb[:, :, None].transpose(-1, -2)) * scale
    t = kb.shape[2]
    for lo, hi in _masked_rows(a, qs.shape[3], k0, t, causal, window):
        qpos = a + lo + torch.arange(hi - lo, device=qs.device)[:, None]
        kpos = k0 + torch.arange(t, device=qs.device)[None, :]
        mask = torch.ones((hi - lo, t), dtype=torch.bool, device=qs.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s[..., lo:hi, :] = torch.where(mask, s[..., lo:hi, :], -1e30)
    return s


def _online_softmax(q, k, v, causal: bool, window: Optional[int],
                    k_chunk: int, scale: float):
    """The forward of :class:`FlashAttention`: (out (B, H, Sq, Dv) in q's
    dtype, lse (B, Kv, G, Sq) f32).  An online softmax over the key blocks
    of :func:`_key_blocks`, each updating only the query rows that see one
    of its keys (:func:`_block_rows`), in f32; the largest temporary is one
    block's (B, Kv, G, rows, block) logits."""
    B, H, Sq, D = q.shape
    Kv, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    qr = q.reshape(B, Kv, H // Kv, Sq, D).float()
    kf, vf = k.float(), v.float()
    t, nk = _key_blocks(Skv, k_chunk)
    m = qr.new_full(qr.shape[:4], -1e30)
    l = qr.new_zeros(qr.shape[:4])
    acc = qr.new_zeros(qr.shape[:4] + (Dv,))
    for i in range(nk):
        a, b = _block_rows(i * t, (i + 1) * t, Sq, causal, window)
        if a == b:
            continue
        kb = kf[:, :, i * t:(i + 1) * t]
        vb = vf[:, :, i * t:(i + 1) * t]
        s = _block_logits(qr[:, :, :, a:b], kb, a, i * t, scale, causal,
                          window)
        # in place on the block's rows: the same products and sums, no
        # copy of the (rows, Dv) accumulator
        mr = m[..., a:b]
        mc = torch.maximum(mr, s.amax(dim=-1))
        p = s.sub_(mc[..., None]).exp_()
        alpha = torch.exp(mr - mc)
        l[..., a:b].mul_(alpha).add_(p.sum(dim=-1))
        acc[..., a:b, :].mul_(alpha[..., None]).add_(
            torch.matmul(p, vb[:, :, None]))
        mr.copy_(mc)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    out = out.reshape(B, H, Sq, Dv)
    return out, lse


class FlashAttention(torch.autograd.Function):
    """Flash attention with the reference's custom VJP (``_flash_attn``,
    plain f32 arithmetic): q (B, H, Sq, D), k (B, Kv, Skv, D), v (B, Kv,
    Skv, Dv), Dv free (MLA's), GQA with kv head h // (H / Kv); queries at
    positions 0..Sq-1, as in a training forward.

    Forward: online softmax over key blocks of :func:`_key_blocks`,
    keeping q, k, v, the output and the log-sum-exp (B, Kv, G, Sq).
    Backward: each block's probabilities recomputed from the lse, so no
    (Sq, Skv) tensor is kept between the passes.  Each block updates only
    the query rows that see one of its keys (:func:`_block_rows`): in the
    reference's arithmetic a row's fully masked block adds exactly 0 (its
    probabilities are exp(-1e30 - m) = 0), or, before the row's first
    visible key, adds a placeholder that its first visible block scales by
    exp(-1e30 - m) = 0.  So causal attention does half the work for the
    same values: the forward's bits, and key gradients that only leave out
    sums of zeros."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, k_chunk, scale):
        out, lse = _online_softmax(q, k, v, causal, window, k_chunk, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, window, k_chunk, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, k_chunk, scale = ctx.cfg
        B, H, Sq, D = q.shape
        Kv, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
        G = H // Kv
        qr = q.reshape(B, Kv, G, Sq, D).float()
        do = dout.reshape(B, Kv, G, Sq, Dv).float()
        delta = torch.sum(do * out.reshape(B, Kv, G, Sq, Dv).float(), dim=-1)
        t, nk = _key_blocks(Skv, k_chunk)
        dq = torch.zeros_like(qr)
        dk = qr.new_zeros((B, Kv, Skv, D))
        dv = qr.new_zeros((B, Kv, Skv, Dv))
        for i in range(nk):
            a, b = _block_rows(i * t, (i + 1) * t, Sq, causal, window)
            if a == b:
                continue
            k0, k1 = i * t, (i + 1) * t
            kb = k[:, :, k0:k1].float()
            vb = v[:, :, k0:k1].float()
            qs, dos = qr[:, :, :, a:b], do[:, :, :, a:b]
            s = _block_logits(qs, kb, a, k0, scale, causal, window)
            p = torch.exp(s - lse[..., a:b, None])
            dv[:, :, k0:k1] = torch.einsum("bkgqc,bkgqd->bkcd", p, dos)
            dp = torch.matmul(dos, vb[:, :, None].transpose(-1, -2))
            ds = p * (dp - delta[..., a:b, None]) * scale
            dq[:, :, :, a:b] += torch.matmul(ds, kb[:, :, None])
            dk[:, :, k0:k1] = torch.einsum("bkgqc,bkgqd->bkcd", ds, qs)
        return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None)


def flash_attn(q, k, v, *, causal: bool = True,
               window: Optional[int] = None, k_chunk: int = 64,
               scale: Optional[float] = None) -> torch.Tensor:
    """:class:`FlashAttention` (the training attention); scale D ** -0.5
    unless given."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return FlashAttention.apply(q, k, v, causal, window, k_chunk, scale)


def online_attention(q, k, v, *, causal: bool = True,
                     window: Optional[int] = None, k_chunk: int = 64,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Attention by :class:`FlashAttention`'s forward, outside autograd
    (MLA serving's route); the shapes and the scale of :func:`flash_attn`."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _online_softmax(q, k, v, causal, window, k_chunk, scale)[0]


def _attend(cfg: LMConfig, q, k, v, *, causal: bool, window: Optional[int]):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash_attn(q, k, v, causal=causal, window=window,
                          k_chunk=cfg.k_chunk)
    if attention_route(cfg) == "flash":
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    return online_attention(q, k, v, causal=causal, window=window,
                            k_chunk=cfg.k_chunk)


def _rope_dim(cfg: LMConfig) -> int:
    return cfg.head_dim if cfg.mla is None else cfg.mla.rope_head_dim


def _project(cfg: LMConfig, p, x, rot):
    """q, k, v (B, S, heads, dim), and the latent (c_kv, k_rope) of MLA
    (None for GQA); rot: :func:`rope_tables` of the positions."""
    B, S, _ = x.shape
    if cfg.mla is None:
        hd = cfg.head_dim
        if cfg.fused_qkv:
            H, Kv = cfg.n_heads, cfg.n_kv_heads
            qkv = x @ p["wqkv"]
            q = qkv[..., :H * hd].reshape(B, S, H, hd)
            k = qkv[..., H * hd:(H + Kv) * hd].reshape(B, S, Kv, hd)
            v = qkv[..., (H + Kv) * hd:].reshape(B, S, Kv, hd)
        else:                           # this rank's heads over a mesh
            q = (x @ p["wq"]).reshape(B, S, -1, hd)
            k = (x @ p["wk"]).reshape(B, S, -1, hd)
            v = (x @ p["wv"]).reshape(B, S, -1, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, p["q_norm"])
            k = rmsnorm(k, p["k_norm"])
        return _rotate(q, rot), _rotate(k, rot), v, None
    m = cfg.mla
    r, nope = m.kv_lora_rank, m.nope_head_dim
    H = p["wq_b"].shape[1] // (nope + m.rope_head_dim)
    cq = rmsnorm(x @ p["wq_a"], p["q_a_norm"])
    q = (cq @ p["wq_b"]).reshape(B, S, H, nope + m.rope_head_dim)
    kv_a = x @ p["wkv_a"]
    c_kv = rmsnorm(kv_a[..., :r], p["kv_a_norm"])
    k_rope = _rotate(kv_a[..., r:].reshape(B, S, 1, m.rope_head_dim), rot)
    q = torch.cat([q[..., :nope], _rotate(q[..., nope:], rot)], dim=-1)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
    k_nope = (c_kv @ p["wk_b"]).reshape(B, S, H, nope)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.rope_head_dim)], dim=-1)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"])
    v = (c_kv @ p["wv_b"]).reshape(B, S, H, m.v_head_dim)
    return q, k, v, (c_kv, k_rope[:, :, 0])


def _attention(cfg: LMConfig, p, x, rot, *, return_kv: bool = False):
    """Causal (windowed) self-attention over the whole sequence.  Returns
    (out (B, S, d), this layer's cache entries or None)."""
    B, S, _ = x.shape
    q, k, v, latent = _project(cfg, p, x, rot)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))        # (B, heads, S, dim)
    out = _attend(cfg, q, k, v, causal=True, window=cfg.window)
    out = (out.transpose(1, 2).reshape(B, S, -1) @ p["wo"]).to(x.dtype)
    if not return_kv:
        return out, None
    if latent is not None:
        return out, {"ckv": latent[0], "krope": latent[1]}
    return out, {"k": k, "v": v}


def _decode_keys(cfg: LMConfig, ck, cv, L: int):
    """The keys and values a decode step at position L attends to, with its
    causal flag and window, from a ring cache (B, Kv, Smax, hd) whose slot
    L % Smax was just written.  Before the ring wraps: the first L + 1
    slots under the causal window.  After: every slot the reference's mask
    keeps (the newest min(window, Smax)), brought into position order
    where that is not all of them, and no mask."""
    Smax = ck.shape[2]
    if L + 1 <= Smax:
        return ck[:, :, :L + 1], cv[:, :, :L + 1], True, cfg.window
    n = Smax if cfg.window is None else min(cfg.window, Smax)
    if n == Smax:           # every slot visible: order does not matter
        return ck, cv, False, None
    idx = (torch.arange(n, device=ck.device) + (L % Smax - n + 1)) % Smax
    return ck.index_select(2, idx), cv.index_select(2, idx), False, None


def _decode_attention(cfg: LMConfig, p, x, L: int, rot, ck, cv):
    """GQA decode (S == 1) at position L: the ring write at L % Smax, then
    one attention call of (B, H, 1, hd) over the visible slots."""
    B = x.shape[0]
    q, k, v, _ = _project(cfg, p, x, rot)
    write = L % ck.shape[2]
    ck[:, :, write] = k[:, 0].to(ck.dtype)
    cv[:, :, write] = v[:, 0].to(cv.dtype)
    keys, vals, causal, window = _decode_keys(cfg, ck, cv, L)
    out = _attend(cfg, q.transpose(1, 2), keys, vals, causal=causal,
                  window=window)
    return (out.reshape(B, 1, -1) @ p["wo"]).to(x.dtype)


def _mla_decode_attention(cfg: LMConfig, p, x, L: int, rot, ckv, krope):
    """Absorbed-MLA decode (DeepSeek-V2 style): the cache holds only the
    latent c_kv and the shared RoPE key; W_kb is absorbed into q.  No ring:
    slot L is written while L < Smax, as the reference does."""
    m = cfg.mla
    B, S, _ = x.shape
    H = p["wq_b"].shape[1] // (m.nope_head_dim + m.rope_head_dim)
    cq = rmsnorm(x @ p["wq_a"], p["q_a_norm"])
    q = (cq @ p["wq_b"]).reshape(B, S, H, m.nope_head_dim + m.rope_head_dim)
    q_nope = q[..., :m.nope_head_dim]
    q_rope = _rotate(q[..., m.nope_head_dim:], rot)
    kv_a = x @ p["wkv_a"]
    c_new = rmsnorm(kv_a[..., :m.kv_lora_rank], p["kv_a_norm"])
    kr_new = _rotate(kv_a[..., m.kv_lora_rank:].reshape(
        B, S, 1, m.rope_head_dim), rot)[:, :, 0]
    Smax = ckv.shape[1]
    if L < Smax:
        ckv[:, L] = c_new[:, 0].to(ckv.dtype)
        krope[:, L] = kr_new[:, 0].to(krope.dtype)
    wkb = p["wk_b"].reshape(m.kv_lora_rank, H, m.nope_head_dim).float()
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope.float(), wkb)
    s = (torch.einsum("bshr,bcr->bhc", q_abs, ckv.float())
         + torch.einsum("bshn,bcn->bhc", q_rope.float(), krope.float()))
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    mask = torch.arange(Smax, device=x.device) <= L
    s = torch.where(mask, s * scale, -1e30)
    ctx = torch.einsum("bhc,bcr->bhr", torch.softmax(s, dim=-1), ckv.float())
    wvb = p["wv_b"].reshape(m.kv_lora_rank, H, m.v_head_dim).float()
    out = torch.einsum("bhr,rhv->bhv", ctx, wvb)
    out = out.reshape(B, S, H * m.v_head_dim).to(x.dtype)
    return (out @ p["wo"]).to(x.dtype)


def _mlp(p, x):
    if "w13" in p:
        ff = p["w2"].shape[-2]
        h13 = x @ p["w13"]
        h = F.silu(h13[..., :ff]) * h13[..., ff:]
    else:
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    return (h @ p["w2"]).to(x.dtype)


def _moe_ffn(cfg: LMConfig, p, x, rules: MeshRules, lay=None, e0: int = 0):
    """Sort-based capacity MoE: tokens sorted (stably) by expert fill a
    fixed capacity C per expert (rounded up to 128), overflow goes to a
    sink slot E * C and is dropped.  x (B, S, d) -> (out, aux loss).

    Over a mesh (``lay``) ``x`` is this rank's data shard, one group, as
    the reference groups tokens by data shard; ``p`` holds this rank's
    experts from ``e0`` on (expert parallel) or its ``ff`` columns of
    every expert (tensor parallel within each): the output is this rank's
    partial sum.  The aux loss is the global one (its sums reduced over
    the data shards)."""
    m = cfg.moe
    B, S, d = x.shape
    N = B * S
    meshed = lay is not None and lay.mesh is not None
    if meshed:
        G, n_all = 1, lay.tokens
    else:
        G = rules.dp_size() if B % rules.dp_size() == 0 else 1
        n_all = N
    Ng = N // G
    k, E = m.top_k, m.n_experts
    El = p["w1"].shape[0]
    C = int(np.ceil(Ng * k / E * m.capacity_factor / 128)) * 128
    dev = x.device

    xg = x.reshape(G, Ng, d)
    logits = xg.float() @ p["router"]                              # (G, Ng, E)
    if k == 1:
        gate = torch.softmax(logits, dim=-1).amax(dim=-1, keepdim=True)
        eidx = logits.argmax(dim=-1, keepdim=True)
    else:
        vals, eidx = torch.topk(logits, k, dim=-1)
        gate = torch.softmax(vals, dim=-1)

    fe = eidx.reshape(G, Ng * k)
    ft = torch.arange(Ng, device=dev).repeat_interleave(k)[None].expand(G, -1)
    fg = gate.reshape(G, Ng * k)
    order = torch.sort(fe, dim=-1, stable=True).indices
    se, st, sg = fe.gather(1, order), ft.gather(1, order), fg.gather(1, order)
    starts = torch.searchsorted(se, torch.arange(E, device=dev).expand(G, E))
    pos = torch.arange(Ng * k, device=dev)[None] - starts.gather(1, se)
    keep = pos < C
    if El < E:                      # this rank's experts only
        keep = keep & (se >= e0) & (se < e0 + El)
    slot = torch.where(keep, (se - e0) * C + pos, El * C)          # overflow sink

    xsel = xg.gather(1, st[..., None].expand(-1, -1, d))
    buf = torch.zeros((G, El * C + 1, d), dtype=cfg.dtype, device=dev)
    buf.scatter_(1, slot[..., None].expand(-1, -1, d),
                 torch.where(keep[..., None], xsel, 0).to(cfg.dtype))
    xe = buf[:, :-1].reshape(G, El, C, d)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["w1"])) * torch.einsum(
        "gecd,edf->gecf", xe, p["w3"])
    ye = torch.einsum("gecf,efd->gecd", h, p["w2"])
    yf = torch.cat([ye.reshape(G, El * C, d), ye.new_zeros((G, 1, d))], dim=1)
    contrib = yf.gather(1, slot[..., None].expand(-1, -1, d))
    contrib = contrib * (sg * keep)[..., None].to(ye.dtype)
    out = ye.new_zeros((G, Ng, d)).scatter_add_(
        1, st[..., None].expand(-1, -1, d), contrib)

    aux = _aux_loss(m, logits, fe, lay.dp if meshed else None, n_all)
    return out.reshape(B, S, d).to(x.dtype), aux


def _aux_loss(m: MoEConfig, logits, fe, over, n_all: int):
    """GShard's load-balance loss and the router z-loss over every token:
    this rank's sums over its tokens' router logits (..., E) and expert
    choices ``fe``, summed over the mesh ``over`` (None: they are all of
    them), divided by the ``n_all`` tokens."""
    E = m.n_experts
    dev = logits.device
    sums = torch.cat([
        torch.softmax(logits, dim=-1).reshape(-1, E).sum(dim=0),
        (torch.logsumexp(logits, dim=-1) ** 2).sum().reshape(1),
        torch.zeros(E, device=dev).index_add_(
            0, fe.reshape(-1), torch.ones(fe.numel(), device=dev))])
    if over is not None:
        sums = routed.all_reduce_sum(sums, over)
    me, ce = sums[:E] / n_all, sums[E + 1:] / (n_all * m.top_k)
    return m.aux_coef * E * torch.sum(me * ce) + m.router_z_coef * \
        sums[E] / n_all


# ---------------------------------------------------------------------------
# the layout over a mesh
# ---------------------------------------------------------------------------

def _axes(e) -> tuple:
    return () if e is None else (e,) if isinstance(e, str) else tuple(e)


class _Lay:
    """Where one call's tensors lie (without a mesh: whole, and every
    method the identity).

    Over a mesh, from the model's placements (``Transformer.placements``)
    and the rules: the batch rows of this rank's data block (the batch's
    ``input_sharding``: whole where the data axes do not divide it), and
    the residual stream whole over ``model``, or split over it by its
    sequence where the rules put ``seq_sp`` on it and it divides the
    length.  A weight's ``embed`` dim is gathered over the batch axes
    (FSDP, :meth:`weight`); its ``heads`` / ``kv_heads`` / ``ff`` /
    ``expert`` / ``vocab`` dim keeps this rank's block where that block is
    whole heads (:meth:`span`), else it is gathered and every rank computes
    every head.  A region that sums over a split dim gives partial sums,
    which :meth:`leave` reduces over ``model``.  Each rank's gradients are
    shares (``distributed.routed``)."""

    def __init__(self, cfg: LMConfig, model, rules: MeshRules, shape):
        B, S = shape
        self.cfg, self.rules, self.mesh = cfg, rules, rules.mesh
        self.rows, self.tp, self.dp, self.sp = slice(0, B), None, None, False
        self.tokens, self.world, self.dup = B * S, 1, 1
        if self.mesh is None:
            return
        if model.placements is None:
            raise ValueError("an LM over a mesh needs its parameters' "
                             "placements: build it with shardings= "
                             "(Transformer, init_params) or move it with "
                             "fault_tolerance.reshard_state")
        if cfg.fused_qkv:
            raise NotImplementedError("fused_qkv over a mesh: its fused "
                                      "columns do not split by heads")
        self.pl = model.placements
        self.tp = self.mesh.over(rules.tp)
        bpl = rules.input_sharding((B, S), "batch", None).entries[0]
        if bpl is not None:
            i, n = self.mesh.coord(bpl)
            self.rows = slice(i * B // n, (i + 1) * B // n)
            self.dp = self.mesh.over(bpl)
        self.world = self.mesh.size
        self.dup = self.world // (1 if self.dp is None else self.dp.size)
        self.sp = (rules.seq_sp is not None and self.tp.size > 1
                   and S % self.tp.size == 0)

    def weight(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """``w`` with its FSDP dims gathered over the batch axes."""
        if self.mesh is None:
            return w
        for k, e in enumerate(self.pl[name].entries):
            if e is not None and _axes(e) == _axes(self.rules.fsdp):
                w = routed.all_gather_rows(w, self.mesh.over(e), dim=k)
        return w

    def _split(self, name: str, dim: int) -> bool:
        if self.mesh is None:
            return False
        entries = self.pl[name].entries
        return dim < len(entries) and entries[dim] is not None and \
            _axes(entries[dim]) == _axes(self.rules.tp)

    def span(self, name: str, w: torch.Tensor, dim: int, unit: int):
        """(w, u0, n): ``w`` holding units [u0, u0 + n) of ``unit`` along
        ``dim``: this rank's block where it is whole units, else ``w``
        gathered whole."""
        if self._split(name, dim):
            if w.shape[dim] % unit == 0:
                n = w.shape[dim] // unit
                return w, self.tp.rank * n, n
            w = routed.all_gather_rows(w, self.tp, dim=dim)
        return w, 0, w.shape[dim] // unit

    def take(self, name: str, w: torch.Tensor, dim: int, unit: int,
             u0: int, n: int) -> torch.Tensor:
        """``w``'s units [u0, u0 + n) along ``dim`` (gathered whole first
        where this rank's block is not them)."""
        got, a, m = self.span(name, w, dim, unit)
        if (a, m) == (u0, n):
            return got
        if got is w and self._split(name, dim):
            got = routed.all_gather_rows(w, self.tp, dim=dim)
        return got.narrow(dim, u0 * unit, n * unit)

    def seq_block(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[1] // self.tp.size
        return x.narrow(1, self.tp.rank * n, n)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream as a region reads it: whole over ``model``
        (sequence parallel: gathered by its sequence)."""
        return routed.all_gather_rows(x, self.tp, dim=1) if self.sp else x

    def leave(self, h: torch.Tensor, partial: bool) -> torch.Tensor:
        """A region's output in the residual's layout: partial sums reduced
        over ``model`` (sequence parallel: reduce-scattered by the
        sequence)."""
        if self.sp:
            return (routed.reduce_scatter_rows(h, self.tp, dim=1) if partial
                    else self.seq_block(h))
        return routed.all_reduce_sum(h, self.tp) if partial else h


def _attn_weights(cfg: LMConfig, lay: _Lay, pre: str, p):
    """(this rank's attention weights, whether its output is partial): its
    q heads, the kv heads they read, and wo's rows of those heads."""
    if lay.mesh is None:
        return p, False
    w = {k: lay.weight(pre + k, v) for k, v in p.items()}
    if cfg.mla is None:
        hd, G = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
        w["wq"], h0, nh = lay.span(pre + "wq", w["wq"], 1, hd)
        k0, k1 = h0 // G, (h0 + nh - 1) // G + 1
        if nh % (k1 - k0) or (nh // (k1 - k0) != G and k1 - k0 != 1):
            raise ValueError(f"q heads [{h0}, {h0 + nh}) do not read whole "
                             f"kv heads (group {G})")
        for k in ("wk", "wv"):
            w[k] = lay.take(pre + k, w[k], 1, hd, k0, k1 - k0)
        hv = hd
    else:
        m = cfg.mla
        w["wq_b"], h0, nh = lay.span(pre + "wq_b", w["wq_b"], 1,
                                     m.nope_head_dim + m.rope_head_dim)
        w["wk_b"] = lay.take(pre + "wk_b", w["wk_b"], 1, m.nope_head_dim,
                             h0, nh)
        w["wv_b"] = lay.take(pre + "wv_b", w["wv_b"], 1, m.v_head_dim, h0, nh)
        hv = m.v_head_dim
    w["wo"] = lay.take(pre + "wo", w["wo"], 0, hv, h0, nh)
    return w, nh < cfg.n_heads


def _mlp_weights(cfg: LMConfig, lay: _Lay, pre: str, p):
    """(this rank's MLP weights: its ff columns, whether partial)."""
    if lay.mesh is None:
        return p, False
    w = {k: lay.weight(pre + k, v) for k, v in p.items()}
    w["w1"], f0, nf = lay.span(pre + "w1", w["w1"], 1, 1)
    w["w3"] = lay.take(pre + "w3", w["w3"], 1, 1, f0, nf)
    w["w2"] = lay.take(pre + "w2", w["w2"], 0, 1, f0, nf)
    return w, nf < cfg.d_ff


def _moe_weights(cfg: LMConfig, lay: _Lay, pre: str, p):
    """(this rank's MoE weights, its first expert, whether partial): its
    experts (expert parallel) or its ff columns of every expert."""
    if lay.mesh is None:
        return p, 0, False
    w = {k: lay.weight(pre + k, v) for k, v in p.items()}
    w["w1"], e0, ne = lay.span(pre + "w1", w["w1"], 0, 1)
    w["w1"], f0, nf = lay.span(pre + "w1", w["w1"], 2, 1)
    w["w3"] = lay.take(pre + "w3", lay.take(pre + "w3", w["w3"], 0, 1, e0,
                                            ne), 2, 1, f0, nf)
    w["w2"] = lay.take(pre + "w2", lay.take(pre + "w2", w["w2"], 0, 1, e0,
                                            ne), 1, 1, f0, nf)
    return w, e0, ne < cfg.moe.n_experts or nf < cfg.moe.d_ff


def _moe_exchange(cfg: LMConfig, p, x, lay: _Lay, e0: int):
    """Expert-parallel MoE on this rank's sequence block ``x`` (B, S / M,
    d) of its data shard: (its output, complete, and the aux loss).

    The data shard is one dispatch group, as on the whole sequence: an
    assignment's place in its expert's queue counts the assignments before
    it in (row, position, choice) order, those of the rows before and of
    the lower model ranks' blocks of its row from an all-gather of each
    rank's (row, expert) counts.  Kept assignments travel to their
    expert's rank in one all-to-all of fixed-size slot buffers (a slot per
    (expert, place): each is filled by one rank at most), and the experts'
    outputs travel back in another."""
    m = cfg.moe
    B, Sl, d = x.shape
    M, r = lay.tp.size, lay.tp.rank
    k, E, El = m.top_k, m.n_experts, p["w1"].shape[0]
    C = int(np.ceil(B * Sl * M * k / E * m.capacity_factor / 128)) * 128
    dev = x.device
    logits = x.reshape(B, Sl, d).float() @ p["router"]              # (B, Sl, E)
    if k == 1:
        gate = torch.softmax(logits, dim=-1).amax(dim=-1, keepdim=True)
        eidx = logits.argmax(dim=-1, keepdim=True)
    else:
        vals, eidx = torch.topk(logits, k, dim=-1)
        gate = torch.softmax(vals, dim=-1)
    fe = eidx.reshape(B, Sl * k)
    counts = torch.zeros((B, E), dtype=torch.long, device=dev).scatter_add_(
        1, fe, torch.ones_like(fe))
    every = lay.tp.all_gather(counts)                               # (M, B, E)
    per_row = every.sum(0)
    offset = per_row.cumsum(0) - per_row + every[:r].sum(0)         # (B, E)
    order = torch.sort(fe, dim=-1, stable=True).indices
    se = fe.gather(1, order)
    st = torch.arange(Sl, device=dev).repeat_interleave(k)[order]  # position
    sg = gate.reshape(B, Sl * k).gather(1, order)
    starts = torch.searchsorted(
        se, torch.arange(E, device=dev).expand(B, E).contiguous())
    pos = torch.arange(Sl * k, device=dev)[None] - starts.gather(1, se) + \
        offset.gather(1, se)
    keep = pos < C
    sink = M * El * C
    dest = torch.where(keep, (se // El) * (El * C) + (se % El) * C + pos,
                       sink)
    tok = (torch.arange(B, device=dev)[:, None] * Sl + st).reshape(-1)
    dest = dest.reshape(-1)
    rows = x.reshape(B * Sl, d)[tok]
    buf = torch.zeros((sink + 1, d), dtype=cfg.dtype, device=dev)
    buf = buf.scatter(0, dest[:, None].expand(-1, d),
                      torch.where(keep.reshape(-1, 1), rows, 0).to(cfg.dtype))
    xe = routed.all_to_all(buf[:-1].reshape(M, El * C, d), lay.tp)
    xe = xe.sum(dim=0).reshape(El, C, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, p["w1"])) * torch.einsum(
        "ecd,edf->ecf", xe, p["w3"])
    ye = torch.einsum("ecf,efd->ecd", h, p["w2"]).reshape(1, El * C, d)
    back = routed.all_to_all(ye.expand(M, -1, -1).contiguous(), lay.tp)
    yf = torch.cat([back.reshape(sink, d), back.new_zeros((1, d))])
    contrib = yf[dest] * (sg * keep).reshape(-1, 1).to(yf.dtype)
    out = yf.new_zeros((B * Sl, d)).index_add_(0, tok, contrib)
    # the ranks that hold distinct tokens: every rank where the batch is
    # split over the data axes, else (the rows whole on every data rank)
    # the model ranks' sequence blocks
    over = lay.tp if lay.dp is None else lay.mesh.over(lay.rules.flat)
    aux = _aux_loss(m, logits, fe, over, lay.tokens)
    return out.reshape(B, Sl, d).to(x.dtype), aux


def _ffn(cfg: LMConfig, lay: _Lay, pre: str, layer: Block, x):
    """The MLP or MoE sublayer's output in the residual's layout, and its
    aux loss (None for an MLP)."""
    if hasattr(layer, "moe"):
        p, e0, partial = _moe_weights(cfg, lay, pre + "moe.", layer.moe)
        if lay.sp and p["w1"].shape[0] < cfg.moe.n_experts:
            # expert parallel on sequence-split tokens: an all-to-all
            return _moe_exchange(cfg, p, rmsnorm(x, layer.ln2), lay, e0)
        h, a = _moe_ffn(cfg, p, lay.enter(rmsnorm(x, layer.ln2)), lay.rules,
                        lay, e0)
    else:
        p, partial = _mlp_weights(cfg, lay, pre + "mlp.", layer.mlp)
        h, a = _mlp(p, lay.enter(rmsnorm(x, layer.ln2))), None
    return lay.leave(h, partial), a


def _head(model: Transformer, lay: _Lay):
    """(this rank's vocab columns of the output head (d, n), the first)."""
    if model.cfg.tie_embeddings:
        w, v0, _ = lay.span("embed", lay.weight("embed", model.embed), 0, 1)
        return w.T, v0
    w, v0, _ = lay.span("lm_head", lay.weight("lm_head", model.lm_head), 1, 1)
    return w, v0


def _logits(model: Transformer, lay: _Lay, x):
    """Logits (..., vocab) of the residual ``x`` (whole over ``model``),
    gathered over the vocab and data shards over a mesh."""
    cfg = model.cfg
    head, _ = _head(model, lay)
    logits = rmsnorm(x, model.final_norm) @ head.to(x.dtype)
    if lay.mesh is not None:
        if logits.shape[-1] < cfg.vocab_padded:
            logits = routed.all_gather_rows(logits, lay.tp, dim=-1)
        if lay.dp is not None:
            logits = routed.all_gather_rows(logits, lay.dp, dim=0)
    return logits[..., :cfg.vocab] if cfg.vocab_padded != cfg.vocab else logits


# ---------------------------------------------------------------------------
# forward / loss / decode
# ---------------------------------------------------------------------------

def _embed(cfg: LMConfig, model: Transformer, lay: _Lay, tokens):
    """The residual stream of this rank's rows of ``tokens`` (B, S): over
    a mesh each rank looks up the ids in its vocab block and the ranks'
    rows are summed."""
    tokens = tokens[lay.rows]
    if lay.mesh is None:
        return model.embed[tokens].to(cfg.dtype)
    table, v0, nv = lay.span("embed", lay.weight("embed", model.embed), 0, 1)
    if nv == cfg.vocab_padded:
        x = table[tokens].to(cfg.dtype)
        return lay.seq_block(x) if lay.sp else x
    loc = tokens - v0
    inside = (loc >= 0) & (loc < nv)
    x = table[loc.clamp(0, nv - 1)] * inside[..., None].to(table.dtype)
    return lay.leave(x.to(cfg.dtype), True)


def _tokens(model: Transformer, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=model.device).long()


def _positions(x, S: int):
    """Positions 0..S-1, (rows of x, S)."""
    return torch.arange(S, device=x.device)[None].expand(x.shape[0], S)


def _trunk(cfg: LMConfig, model: Transformer, lay: _Lay, tokens):
    """(the last layer's residual stream, the summed aux loss)."""
    x = _embed(cfg, model, lay, tokens)
    S = tokens.shape[1]
    rot = rope_tables(_positions(x, S), _rope_dim(cfg), cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, layer in enumerate(model.layers):
        if remat:
            x, a = checkpoint(_layer, cfg, lay, i, layer, x, rot,
                              use_reentrant=False)
        else:
            x, a = _layer(cfg, lay, i, layer, x, rot)
        aux = aux if a is None else aux + a
    return x, aux


def forward(cfg: LMConfig, model: Transformer, tokens,
            rules: Optional[MeshRules] = None):
    """tokens (B, S) int -> (logits (B, S, vocab) in cfg.dtype, aux).  Over
    a mesh every rank passes the whole batch and gets the whole logits."""
    rules = rules or make_rules(None)
    tokens = _tokens(model, tokens)
    lay = _Lay(cfg, model, rules, tokens.shape)
    x, aux = _trunk(cfg, model, lay, tokens)
    return _logits(model, lay, lay.enter(x)), aux


def _layer(cfg: LMConfig, lay: _Lay, i: int, layer: Block, x, rot):
    """One sublayer of the forward: (x, aux or None)."""
    p, partial = _attn_weights(cfg, lay, f"layers.{i}.attn.", layer.attn)
    h, _ = _attention(cfg, p, lay.enter(rmsnorm(x, layer.ln1)), rot)
    x = x + lay.leave(h, partial)
    h, a = _ffn(cfg, lay, f"layers.{i}.", layer, x)
    return x + h, a


@torch.inference_mode()
def prefill(cfg: LMConfig, model: Transformer, tokens,
            rules: Optional[MeshRules] = None):
    """Inference prefill: forward pass + KV-cache materialization.
    Returns (last-position logits (B, vocab) f32, cache ready for
    :func:`decode_step`, with Smax = S).  Over a mesh the cache holds this
    rank's rows and the kv heads its q heads read (MLA's latent: whole
    over ``model``), and every rank gets the whole logits."""
    rules = rules or make_rules(None)
    tokens = _tokens(model, tokens)
    lay = _Lay(cfg, model, rules, tokens.shape)
    x = _embed(cfg, model, lay, tokens)
    S = tokens.shape[1]
    rot = rope_tables(_positions(x, S), _rope_dim(cfg), cfg.rope_theta)
    cache: dict = {}
    for i, layer in enumerate(model.layers):
        p, partial = _attn_weights(cfg, lay, f"layers.{i}.attn.", layer.attn)
        h, kv = _attention(cfg, p, lay.enter(rmsnorm(x, layer.ln1)), rot,
                           return_kv=True)
        for name, t in kv.items():
            cache.setdefault(name, []).append(t.to(cfg.dtype).contiguous())
        x = x + lay.leave(h, partial)
        x = x + _ffn(cfg, lay, f"layers.{i}.", layer, x)[0]
    cache["len"] = S
    return _logits(model, lay, lay.enter(x)[:, -1]).float(), cache


def loss_fn(cfg: LMConfig, model: Transformer, batch: dict,
            rules: Optional[MeshRules] = None):
    """batch = {tokens (B, S), labels? (B, S)}; next-token cross-entropy +
    z-loss + aux.  Returns (objective, metrics); differentiable when grad
    is enabled (the training attention, layers checkpointed with
    ``remat``).

    Over a mesh every rank passes the whole batch and holds its vocab
    columns of the logits: each shard's log-sum-exp (padded columns left
    out) and gold logit are combined over the vocab shards.  Each token's
    terms are on ``lay.dup`` ranks and the aux loss on every rank, so the
    objective has the global value and the gradient of this rank's share:
    its tokens' sum over (global tokens x dup) plus aux / ranks (without a
    mesh: the whole objective)."""
    rules = rules or make_rules(None)
    tokens = _tokens(model, batch["tokens"])
    labels = batch.get("labels")
    if labels is None:
        labels = F.pad(tokens[:, 1:], (0, 1), value=-1)
    labels = torch.as_tensor(labels, device=model.device).long()
    lay = _Lay(cfg, model, rules, tokens.shape)
    x, aux = _trunk(cfg, model, lay, tokens)
    head, v0 = _head(model, lay)
    xf = lay.enter(rmsnorm(x, model.final_norm))
    logits = (xf @ head.to(xf.dtype)).float()
    nv = logits.shape[-1]
    lse = torch.logsumexp(logits[..., :min(nv, max(cfg.vocab - v0, 0))],
                          dim=-1)
    rows = labels[lay.rows]
    valid = rows >= 0
    loc = torch.where(valid, rows, 0) - v0
    inside = (loc >= 0) & (loc < nv)
    gold = torch.where(inside, logits.gather(
        -1, loc.clamp(0, nv - 1)[..., None])[..., 0], 0.0)
    if nv < cfg.vocab_padded:                  # the vocab split over model
        top = lay.tp.all_reduce(lse.detach(), "max")
        both = routed.all_reduce_sum(
            torch.stack([torch.exp(lse - top), gold]), lay.tp)
        lse, gold = top + torch.log(both[0]), both[1]
    sums = torch.stack([torch.where(valid, lse - gold, 0.0).sum(),
                        torch.where(valid, lse ** 2, 0.0).sum()])
    ntok = (labels >= 0).sum().clamp(min=1)
    share = (sums[0] + 1e-4 * sums[1]) / (ntok * lay.dup) + aux / lay.world
    tot = sums.detach()
    if lay.dp is not None:
        tot = lay.dp.all_reduce(tot, "sum")
    loss, zloss = tot[0] / ntok, 1e-4 * tot[1] / ntok
    value = loss + zloss + aux.detach()
    return share + (value - share).detach(), {"loss": loss,
                                              "aux": aux.detach(),
                                              "ntok": ntok}


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None, *,
               device=None) -> dict:
    """Per-layer KV caches: GQA k / v (B, Kv, max_len, hd); MLA the latent
    c_kv (B, max_len, kv_lora_rank) and the shared RoPE key (B, max_len,
    rope_head_dim).  For sliding-window models pass max_len=window to get
    a ring buffer."""
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)

    def zeros(*shape):
        return [torch.zeros(shape, dtype=dtype, device=dev)
                for _ in range(cfg.n_layers)]

    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": zeros(batch, max_len, m.kv_lora_rank),
                "krope": zeros(batch, max_len, m.rope_head_dim), "len": 0}
    Kv, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": zeros(batch, Kv, max_len, hd),
            "v": zeros(batch, Kv, max_len, hd), "len": 0}


def _seq_dim(name: str) -> int:
    return 2 if name in ("k", "v") else 1


def grow_cache(cache: dict, max_len: int) -> dict:
    """The cache with its slots zero-padded to max_len (a prefilled cache
    right-sized for decoding; no change where it already holds max_len or
    more)."""
    out = {"len": cache["len"]}
    for name, layers in cache.items():
        if name == "len":
            continue
        dim = _seq_dim(name)
        pad = max_len - layers[0].shape[dim]
        out[name] = layers if pad <= 0 else [
            torch.cat([t, t.new_zeros(t.shape[:dim] + (pad,)
                                      + t.shape[dim + 1:])], dim=dim)
            for t in layers]
    return out


@torch.inference_mode()
def decode_step(cfg: LMConfig, model: Transformer, cache: dict, tokens,
                rules: Optional[MeshRules] = None):
    """One decode step. tokens (B, 1) -> (logits (B, vocab) f32, cache).
    The cache is updated in place and returned, its len one more.  Over a
    mesh every rank passes the whole tokens and its block of the cache
    (as :func:`prefill` gives it) and gets the whole logits."""
    rules = rules or make_rules(None)
    tokens = _tokens(model, tokens)
    lay = _Lay(cfg, model, rules, tokens.shape)
    x = _embed(cfg, model, lay, tokens)
    L = int(cache["len"])
    rot = rope_tables(torch.full(x.shape[:2], L, device=x.device),
                      _rope_dim(cfg), cfg.rope_theta)
    for i, layer in enumerate(model.layers):
        p, partial = _attn_weights(cfg, lay, f"layers.{i}.attn.", layer.attn)
        hin = rmsnorm(x, layer.ln1)
        if cfg.mla is not None:
            h = _mla_decode_attention(cfg, p, hin, L, rot,
                                      cache["ckv"][i], cache["krope"][i])
        else:
            h = _decode_attention(cfg, p, hin, L, rot,
                                  cache["k"][i], cache["v"][i])
        x = x + lay.leave(h, partial)
        x = x + _ffn(cfg, lay, f"layers.{i}.", layer, x)[0]
    cache["len"] = L + 1
    return _logits(model, lay, x)[:, 0].float(), cache


# ---------------------------------------------------------------------------
# the reference's stacked cache
# ---------------------------------------------------------------------------

def cache_from_reference(cfg: LMConfig, tree: dict, *, device=None) -> dict:
    """The reference's stacked cache (numpy; k / v (G, P, B, Smax, Kv, hd),
    ckv / krope (G, P, B, Smax, r)) as this module's per-layer cache."""
    dev = resolve_device(device)
    out = {"len": int(np.asarray(tree["len"]))}
    P = cfg.moe_period
    for name, a in tree.items():
        if name == "len":
            continue
        a = np.asarray(a)
        layers = [_to_torch(a[i // P, i % P]) for i in range(cfg.n_layers)]
        if name in ("k", "v"):
            layers = [t.transpose(1, 2).contiguous() for t in layers]
        out[name] = [t.to(dev) for t in layers]
    return out


def cache_to_reference(cfg: LMConfig, cache: dict) -> dict:
    """This module's per-layer cache as the reference's stacked numpy tree
    (f32 for a bf16 cache: numpy has no bfloat16)."""
    out = {"len": np.int32(cache["len"])}
    G, P = cfg.n_groups, cfg.moe_period
    for name, layers in cache.items():
        if name == "len":
            continue
        ts = [t.transpose(1, 2) if name in ("k", "v") else t for t in layers]
        a = torch.stack(ts).detach().cpu()
        a = (a.float() if a.dtype == torch.bfloat16 else a).numpy()
        out[name] = a.reshape((G, P) + a.shape[1:])
    return out
