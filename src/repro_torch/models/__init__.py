"""The model stack: the LM transformer family, the GNN family and FM."""
from . import gnn, recsys, transformer
