"""qwen3-14b [dense] 40L d5120 40H (GQA kv=8) d_ff=17408 vocab=151936, qk_norm.

[hf:Qwen/Qwen3-8B; hf]
"""
import torch

from ..models.transformer import LMConfig
from .common import ArchConfig


def config() -> ArchConfig:
    model = LMConfig(
        name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
        head_dim=128, d_ff=17408, vocab=151936, qk_norm=True, rope_theta=1e6,
        dtype=torch.bfloat16)
    smoke = LMConfig(
        name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=128, qk_norm=True, dtype=torch.float32,
        k_chunk=16)
    return ArchConfig(
        name="qwen3-14b", family="lm", model=model, smoke=smoke,
        skips={"long_500k": "pure full attention (no sub-quadratic path)"})
