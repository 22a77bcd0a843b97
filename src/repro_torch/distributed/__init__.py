"""Logical-axis sharding rules of the model stack over a process mesh,
collectives and DGAS exchanges under autograd, and the fault-tolerant
training loop."""
from . import fault_tolerance, routed, sharding
