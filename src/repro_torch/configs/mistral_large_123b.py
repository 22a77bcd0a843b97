"""mistral-large-123b [dense] 88L d12288 96H (GQA kv=8) d_ff=28672 vocab=32768.

[hf:mistralai/Mistral-Large-Instruct-2407; unverified]
"""
import torch

from ..models.transformer import LMConfig
from .common import ArchConfig


def config() -> ArchConfig:
    model = LMConfig(
        name="mistral-large-123b", n_layers=88, d_model=12288, n_heads=96,
        n_kv_heads=8, head_dim=128, d_ff=28672, vocab=32768,
        rope_theta=1e6, dtype=torch.bfloat16)
    smoke = LMConfig(
        name="mistral-large-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=128, rope_theta=1e6,
        dtype=torch.float32, k_chunk=16)
    return ArchConfig(
        name="mistral-large-123b", family="lm", model=model, smoke=smoke,
        skips={"long_500k": "pure full attention (no sub-quadratic path); "
                            "see DESIGN.md §4"},
        notes="largest dense LM in the pool; FSDP+TP memory plan DESIGN.md §7")
