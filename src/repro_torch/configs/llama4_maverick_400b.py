"""llama4-maverick-400b-a17b [moe] 48L d5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 experts top-1, dense/MoE interleaved (period 2).

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
The early-fusion vision frontend is a stub (text backbone only; the specs
give token ids).  bf16 Adam moments.
"""
import torch

from ..models.transformer import LMConfig, MoEConfig
from .common import ArchConfig


def config() -> ArchConfig:
    model = LMConfig(
        name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=202048,
        moe=MoEConfig(n_experts=128, top_k=1, d_ff=8192, period=2),
        rope_theta=5e5, dtype=torch.bfloat16)
    smoke = LMConfig(
        name="llama4-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=128, dtype=torch.float32,
        moe=MoEConfig(n_experts=4, top_k=1, d_ff=64, period=2), k_chunk=16)
    return ArchConfig(
        name="llama4-maverick-400b-a17b", family="lm", model=model,
        smoke=smoke, moment_dtype=torch.bfloat16,
        skips={"long_500k": "full attention backbone here (chunked-attention "
                            "variant not modeled); see DESIGN.md §4"})
