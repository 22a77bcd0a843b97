"""Logical-axis sharding rules of the model stack (one device so far)."""
from . import sharding
