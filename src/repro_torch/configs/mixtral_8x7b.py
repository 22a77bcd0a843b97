"""mixtral-8x7b [moe] 32L d4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
8 experts top-2, sliding-window attention (4096). [arXiv:2401.04088; hf]
"""
import torch

from ..models.transformer import LMConfig, MoEConfig
from .common import ArchConfig


def config() -> ArchConfig:
    model = LMConfig(
        name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=14336, vocab=32000, window=4096,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=14336, period=1),
        rope_theta=1e6, dtype=torch.bfloat16)
    smoke = LMConfig(
        name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=128, window=8, dtype=torch.float32,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=64, period=1), k_chunk=16)
    return ArchConfig(
        name="mixtral-8x7b", family="lm", model=model, smoke=smoke,
        notes="SWA makes long_500k decodable with a window-sized ring cache "
              "(the only LM in the pool that runs that cell)")
