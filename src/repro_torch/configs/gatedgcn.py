"""gatedgcn [gnn] 16L d70, gated edge aggregation. [arXiv:2003.00982; paper]"""
from ..models.gnn import GNNConfig
from .common import ArchConfig


def config() -> ArchConfig:
    model = GNNConfig(name="gatedgcn", arch="gatedgcn", n_layers=16,
                      d_hidden=70, d_feat=100)
    smoke = GNNConfig(name="gatedgcn-smoke", arch="gatedgcn", n_layers=3,
                      d_hidden=16, d_feat=8)
    return ArchConfig(name="gatedgcn", family="gnn", model=model, smoke=smoke)
