"""gin-tu [gnn] 5L d64 sum aggregator, learnable eps. [arXiv:1810.00826; paper]"""
from ..models.gnn import GNNConfig
from .common import ArchConfig


def config() -> ArchConfig:
    model = GNNConfig(name="gin-tu", arch="gin", n_layers=5, d_hidden=64,
                      d_feat=100, eps_learnable=True)
    smoke = GNNConfig(name="gin-smoke", arch="gin", n_layers=2, d_hidden=16,
                      d_feat=8)
    return ArchConfig(name="gin-tu", family="gnn", model=model, smoke=smoke)
