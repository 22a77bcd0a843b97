"""dimenet [gnn] 6 blocks d128 n_bilinear=8 n_spherical=7 n_radial=6.

[arXiv:2003.03123; unverified]  Triplet lists precomputed by the data
pipeline; triplet count capped at 4*E for the huge shapes (sampled triplets).
"""
from ..models.gnn import GNNConfig
from .common import ArchConfig


def config() -> ArchConfig:
    model = GNNConfig(name="dimenet", arch="dimenet", n_layers=6, d_hidden=128,
                      d_feat=100, n_radial=6, n_spherical=7, n_bilinear=8)
    smoke = GNNConfig(name="dimenet-smoke", arch="dimenet", n_layers=2,
                      d_hidden=16, d_feat=8, n_radial=4, n_spherical=3,
                      n_bilinear=4)
    return ArchConfig(name="dimenet", family="gnn", model=model, smoke=smoke)
