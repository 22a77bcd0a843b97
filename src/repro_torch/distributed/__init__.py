"""Logical-axis sharding rules of the model stack (one device so far) and
the fault-tolerant training loop."""
from . import fault_tolerance, sharding
