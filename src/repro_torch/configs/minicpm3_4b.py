"""minicpm3-4b [dense] 62L d2560 40H d_ff=6400 vocab=73448 — MLA attention.

[hf:openbmb/MiniCPM3-4B; hf]  MLA dims: q_lora=768, kv_lora=256,
qk_nope=64, qk_rope=32, v_head=64 (MiniCPM3 reference config).
"""
import torch

from ..models.transformer import LMConfig, MLAConfig
from .common import ArchConfig


def config() -> ArchConfig:
    mla = MLAConfig(q_lora_rank=768, kv_lora_rank=256, rope_head_dim=32,
                    nope_head_dim=64, v_head_dim=64)
    model = LMConfig(
        name="minicpm3-4b", n_layers=62, d_model=2560, n_heads=40,
        n_kv_heads=40, head_dim=96, d_ff=6400, vocab=73448, mla=mla,
        rope_theta=1e4, dtype=torch.bfloat16)
    smoke = LMConfig(
        name="minicpm3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=24, d_ff=128, vocab=128, dtype=torch.float32,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16), k_chunk=16)
    return ArchConfig(
        name="minicpm3-4b", family="lm", model=model, smoke=smoke,
        skips={"long_500k": "pure full attention (MLA latent cache but "
                            "quadratic prefill/decode attention)"},
        notes="MLA: decode uses absorbed latent-cache attention")
