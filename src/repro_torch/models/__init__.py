"""The model stack's serving path: the LM transformer family and FM."""
from . import recsys, transformer
