"""fm [recsys] 39 sparse fields, embed_dim=10, FM 2-way interactions via the
O(nk) sum-square trick. [ICDM'10 (Rendle); paper]

Tables: 39 fields x 1M rows, linear+latent fused into one (V, 1+k) table so a
single fine-grained gather serves both.
"""
from ..models.recsys import FMConfig
from .common import ArchConfig


def config() -> ArchConfig:
    model = FMConfig(name="fm", n_fields=39, embed_dim=10,
                     rows_per_field=1_000_000)
    smoke = FMConfig(name="fm-smoke", n_fields=6, embed_dim=4,
                     rows_per_field=1000)
    return ArchConfig(name="fm", family="recsys", model=model, smoke=smoke)
