"""Hand-written CUDA kernels for Hopper (sm_90a) with their plain torch
versions; CPU tensors take the plain version."""
from . import ops, ref
