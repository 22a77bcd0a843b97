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
differs from v's, runs the plain version (``kernels.ref.flash_attention_ref``),
and its decode the absorbed latent form.  ``prefill`` and ``decode_step``
run under ``inference_mode``.  With ``remat`` a training forward
checkpoints each layer (``torch.utils.checkpoint``, the reference's
``jax.checkpoint(nothing_saveable)``).

Decode keeps one KV cache per layer, (B, Kv, Smax, hd), so a step's B6
call reads the cache's first slots in place, with no transpose or copy;
``cache["len"]`` is one Python int shared by the batch.  The cache is
updated in place.
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
from ..distributed.sharding import MeshRules, make_rules
from ..kernels import ops
from ..kernels.ref import flash_attention_ref

__all__ = ["LMConfig", "MoEConfig", "MLAConfig", "Transformer", "init_params",
           "forward", "prefill", "loss_fn", "init_cache", "decode_step",
           "grow_cache", "count_params", "attention_route", "rmsnorm", "rope",
           "rope_tables", "params_from_reference", "cache_from_reference",
           "cache_to_reference", "FlashAttention", "flash_attn",
           "param_logical_axes"]


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
    """"flash" (B6 through ``ops.flash_attention``) or "plain" (MLA: a q / k
    head dim outside B6's and a v head dim unlike q's)."""
    return "plain" if cfg.mla is not None else "flash"


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


def _init(shape, fan_in, dtype, gen, device) -> nn.Parameter:
    """N(0, 1 / fan_in) drawn in f32 and cast (fan_in None: a norm, ones
    in f32).  gen None on the meta device (shapes only)."""
    if fan_in is None:
        return nn.Parameter(torch.ones(shape, dtype=torch.float32,
                                       device=device))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return nn.Parameter(w.div_(math.sqrt(fan_in)).to(dtype))


class Block(nn.Module):
    """One sublayer: ln1, attention, ln2, and a dense MLP or an MoE."""

    def __init__(self, cfg: LMConfig, is_moe: bool, gen, device):
        super().__init__()
        self.ln1 = _init((cfg.d_model,), None, None, gen, device)
        self.ln2 = _init((cfg.d_model,), None, None, gen, device)
        self.attn = nn.ParameterDict({
            k: _init(s, f, cfg.dtype, gen, device)
            for k, (s, f) in _attn_shapes(cfg).items()})
        ffn = nn.ParameterDict({
            k: _init(s, f, torch.float32 if k == "router" else cfg.dtype,
                     gen, device)
            for k, (s, f) in _ffn_shapes(cfg, is_moe).items()})
        if is_moe:
            self.moe = ffn
        else:
            self.mlp = ffn


class Transformer(nn.Module):
    """The LM stack with its parameters, drawn from ``seed`` by a
    ``torch.Generator`` on ``device`` (CUDA unless ``device`` says
    otherwise; a CUDA request without a card raises; ``meta`` gives the
    shapes alone)."""

    def __init__(self, cfg: LMConfig, *, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        self.cfg = cfg
        P = cfg.moe_period
        self.layers = nn.ModuleList(
            Block(cfg, cfg.moe is not None and i % P == P - 1, gen, dev)
            for i in range(cfg.n_layers))
        self.embed = _init((cfg.vocab_padded, cfg.d_model), cfg.d_model,
                           cfg.dtype, gen, dev)
        self.final_norm = _init((cfg.d_model,), None, None, gen, dev)
        if not cfg.tie_embeddings:
            self.lm_head = _init((cfg.d_model, cfg.vocab_padded), cfg.d_model,
                                 cfg.dtype, gen, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def forward(self, tokens, rules: Optional[MeshRules] = None):
        return forward(self.cfg, self, tokens, rules)


def init_params(cfg: LMConfig, seed: int = 0, *, device=None) -> Transformer:
    """The reference's ``init_params``: a :class:`Transformer` whose
    parameters are drawn from ``seed``."""
    return Transformer(cfg, seed=seed, device=device)


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


def _block_logits(qs, kb, a: int, k0: int, scale: float, causal: bool,
                  window: Optional[int]):
    """Scaled logits of the query rows qs (B, Kv, G, r, D), positions a to
    a + r - 1, against the key block kb (B, Kv, t, D) starting at key k0,
    in f32, -1e30 where masked."""
    s = torch.matmul(qs, kb[:, :, None].transpose(-1, -2)) * scale
    qpos = a + torch.arange(qs.shape[3], device=qs.device)[:, None]
    kpos = k0 + torch.arange(kb.shape[2], device=qs.device)[None, :]
    mask = torch.ones((qs.shape[3], kb.shape[2]), dtype=torch.bool,
                      device=qs.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return torch.where(mask, s, -1e30)


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
        B, H, Sq, D = q.shape
        Kv, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
        qr = q.reshape(B, Kv, H // Kv, Sq, D).float()
        t, nk = _key_blocks(Skv, k_chunk)
        m = qr.new_full(qr.shape[:4], -1e30)
        l = qr.new_zeros(qr.shape[:4])
        acc = qr.new_zeros(qr.shape[:4] + (Dv,))
        for i in range(nk):
            a, b = _block_rows(i * t, (i + 1) * t, Sq, causal, window)
            if a == b:
                continue
            kb = k[:, :, i * t:(i + 1) * t].float()
            vb = v[:, :, i * t:(i + 1) * t].float()
            s = _block_logits(qr[:, :, :, a:b], kb, a, i * t, scale, causal,
                              window)
            mr = m[..., a:b]
            mc = torch.maximum(mr, s.amax(dim=-1))
            p = torch.exp(s - mc[..., None])
            alpha = torch.exp(mr - mc)
            l[..., a:b] = l[..., a:b] * alpha + p.sum(dim=-1)
            acc[..., a:b, :] = acc[..., a:b, :] * alpha[..., None] + \
                torch.matmul(p, vb[:, :, None])
            m[..., a:b] = mc
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        out = out.reshape(B, H, Sq, Dv)
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


def _attend(cfg: LMConfig, q, k, v, *, causal: bool, window: Optional[int]):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash_attn(q, k, v, causal=causal, window=window,
                          k_chunk=cfg.k_chunk)
    if attention_route(cfg) == "flash":
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)


def _rope_dim(cfg: LMConfig) -> int:
    return cfg.head_dim if cfg.mla is None else cfg.mla.rope_head_dim


def _project(cfg: LMConfig, p, x, rot):
    """q, k, v (B, S, heads, dim), and the latent (c_kv, k_rope) of MLA
    (None for GQA); rot: :func:`rope_tables` of the positions."""
    B, S, _ = x.shape
    H = cfg.n_heads
    if cfg.mla is None:
        Kv, hd = cfg.n_kv_heads, cfg.head_dim
        if cfg.fused_qkv:
            qkv = x @ p["wqkv"]
            q = qkv[..., :H * hd].reshape(B, S, H, hd)
            k = qkv[..., H * hd:(H + Kv) * hd].reshape(B, S, Kv, hd)
            v = qkv[..., (H + Kv) * hd:].reshape(B, S, Kv, hd)
        else:
            q = (x @ p["wq"]).reshape(B, S, H, hd)
            k = (x @ p["wk"]).reshape(B, S, Kv, hd)
            v = (x @ p["wv"]).reshape(B, S, Kv, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, p["q_norm"])
            k = rmsnorm(k, p["k_norm"])
        return _rotate(q, rot), _rotate(k, rot), v, None
    m = cfg.mla
    r, nope = m.kv_lora_rank, m.nope_head_dim
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
    H = cfg.n_heads
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


def _moe_ffn(cfg: LMConfig, p, x, rules: MeshRules):
    """Sort-based capacity MoE: tokens sorted (stably) by expert fill a
    fixed capacity C per expert (rounded up to 128), overflow goes to a
    sink slot E * C and is dropped.  x (B, S, d) -> (out, aux loss)."""
    m = cfg.moe
    B, S, d = x.shape
    N = B * S
    G = rules.dp_size() if B % rules.dp_size() == 0 else 1
    Ng = N // G
    k, E = m.top_k, m.n_experts
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
    slot = torch.where(keep, se * C + pos, E * C)                  # overflow sink

    xsel = xg.gather(1, st[..., None].expand(-1, -1, d))
    buf = torch.zeros((G, E * C + 1, d), dtype=cfg.dtype, device=dev)
    buf.scatter_(1, slot[..., None].expand(-1, -1, d),
                 torch.where(keep[..., None], xsel, 0).to(cfg.dtype))
    xe = buf[:, :-1].reshape(G, E, C, d)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["w1"])) * torch.einsum(
        "gecd,edf->gecf", xe, p["w3"])
    ye = torch.einsum("gecf,efd->gecd", h, p["w2"])
    yf = torch.cat([ye.reshape(G, E * C, d), ye.new_zeros((G, 1, d))], dim=1)
    contrib = yf.gather(1, slot[..., None].expand(-1, -1, d))
    contrib = contrib * (sg * keep)[..., None].to(ye.dtype)
    out = ye.new_zeros((G, Ng, d)).scatter_add_(
        1, st[..., None].expand(-1, -1, d), contrib)

    # aux losses (GShard load balance + router z-loss)
    me = torch.softmax(logits, dim=-1).mean(dim=(0, 1))            # (E,)
    ce = torch.zeros(E, device=dev).index_add_(
        0, fe.reshape(-1), torch.ones(N * k, device=dev)) / (N * k)
    aux = m.aux_coef * E * torch.sum(me * ce) + m.router_z_coef * torch.mean(
        torch.logsumexp(logits, dim=-1) ** 2)
    return out.reshape(B, S, d).to(x.dtype), aux


def _ffn(cfg: LMConfig, layer: Block, x, rules: MeshRules):
    hin = rmsnorm(x, layer.ln2)
    if hasattr(layer, "moe"):
        return _moe_ffn(cfg, layer.moe, hin, rules)
    return _mlp(layer.mlp, hin), None


def _logits(model: Transformer, x):
    cfg = model.cfg
    logits = rmsnorm(x, model.final_norm) @ model.head().to(x.dtype)
    return logits[..., :cfg.vocab] if cfg.vocab_padded != cfg.vocab else logits


# ---------------------------------------------------------------------------
# forward / loss / decode
# ---------------------------------------------------------------------------

def _embed(cfg: LMConfig, model: Transformer, tokens):
    tokens = torch.as_tensor(tokens, device=model.device).long()
    return tokens, model.embed[tokens].to(cfg.dtype)


def forward(cfg: LMConfig, model: Transformer, tokens,
            rules: Optional[MeshRules] = None):
    """tokens (B, S) int -> (logits (B, S, vocab) in cfg.dtype, aux)."""
    rules = rules or make_rules(None)
    tokens, x = _embed(cfg, model, tokens)
    B, S = tokens.shape
    rot = rope_tables(torch.arange(S, device=x.device)[None].expand(B, S),
                      _rope_dim(cfg), cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in model.layers:
        if remat:
            x, a = checkpoint(_layer, cfg, layer, x, rot, rules,
                              use_reentrant=False)
        else:
            x, a = _layer(cfg, layer, x, rot, rules)
        aux = aux if a is None else aux + a
    return _logits(model, x), aux


def _layer(cfg: LMConfig, layer: Block, x, rot, rules: MeshRules):
    """One sublayer of the forward: (x, aux or None)."""
    h, _ = _attention(cfg, layer.attn, rmsnorm(x, layer.ln1), rot)
    x = x + h
    h, a = _ffn(cfg, layer, x, rules)
    return x + h, a


@torch.inference_mode()
def prefill(cfg: LMConfig, model: Transformer, tokens,
            rules: Optional[MeshRules] = None):
    """Inference prefill: forward pass + KV-cache materialization.
    Returns (last-position logits (B, vocab) f32, cache ready for
    :func:`decode_step`, with Smax = S)."""
    rules = rules or make_rules(None)
    tokens, x = _embed(cfg, model, tokens)
    B, S = tokens.shape
    rot = rope_tables(torch.arange(S, device=x.device)[None].expand(B, S),
                      _rope_dim(cfg), cfg.rope_theta)
    cache: dict = {}
    for layer in model.layers:
        h, kv = _attention(cfg, layer.attn, rmsnorm(x, layer.ln1), rot,
                           return_kv=True)
        for name, t in kv.items():
            cache.setdefault(name, []).append(t.to(cfg.dtype).contiguous())
        x = x + h
        x = x + _ffn(cfg, layer, x, rules)[0]
    cache["len"] = S
    return _logits(model, x[:, -1]).float(), cache


def loss_fn(cfg: LMConfig, model: Transformer, batch: dict,
            rules: Optional[MeshRules] = None):
    """batch = {tokens (B, S), labels? (B, S)}; next-token cross-entropy +
    z-loss + aux.  Returns (objective, metrics); differentiable when grad
    is enabled (the training attention, layers checkpointed with
    ``remat``)."""
    tokens = torch.as_tensor(batch["tokens"], device=model.device).long()
    labels = batch.get("labels")
    if labels is None:
        labels = F.pad(tokens[:, 1:], (0, 1), value=-1)
    labels = torch.as_tensor(labels, device=model.device).long()
    logits, aux = forward(cfg, model, tokens, rules)
    logits = logits.float()
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, logz - gold, 0.0)
    ntok = valid.sum().clamp(min=1)
    loss = nll.sum() / ntok
    zloss = 1e-4 * torch.where(valid, logz ** 2, 0.0).sum() / ntok
    return loss + zloss + aux, {"loss": loss, "aux": aux, "ntok": ntok}


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
    The cache is updated in place and returned, its len one more."""
    rules = rules or make_rules(None)
    tokens, x = _embed(cfg, model, tokens)
    L = int(cache["len"])
    rot = rope_tables(torch.full(tokens.shape, L, device=x.device),
                      _rope_dim(cfg), cfg.rope_theta)
    for i, layer in enumerate(model.layers):
        hin = rmsnorm(x, layer.ln1)
        if cfg.mla is not None:
            h = _mla_decode_attention(cfg, layer.attn, hin, L, rot,
                                      cache["ckv"][i], cache["krope"][i])
        else:
            h = _decode_attention(cfg, layer.attn, hin, L, rot,
                                  cache["k"][i], cache["v"][i])
        x = x + h
        x = x + _ffn(cfg, layer, x, rules)[0]
    cache["len"] = L + 1
    return _logits(model, x)[:, 0].float(), cache


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
