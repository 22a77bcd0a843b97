"""equiformer-v2 [gnn] 12L d128 l_max=6 m_max=2 8 heads, eSCN SO(2) conv.

[arXiv:2306.12059; unverified]  Wigner rotations are precomputed per edge by
the data pipeline (DESIGN.md §9).
"""
from ..models.gnn import GNNConfig
from .common import ArchConfig


def config() -> ArchConfig:
    model = GNNConfig(name="equiformer-v2", arch="equiformer_v2", n_layers=12,
                      d_hidden=128, d_feat=100, l_max=6, m_max=2, n_heads=8)
    smoke = GNNConfig(name="equiformer-v2-smoke", arch="equiformer_v2",
                      n_layers=2, d_hidden=16, d_feat=8, l_max=2, m_max=2,
                      n_heads=4)
    return ArchConfig(name="equiformer-v2", family="gnn", model=model,
                      smoke=smoke)
