"""repro_torch: PIUMA's graph-query path on PyTorch and CUDA (NVIDIA H100).

The port of the JAX package ``repro``, slice by slice; ``repro`` stays the
reference.  Entry points build on CUDA unless the caller passes
``device="cpu"``."""
__version__ = "0.1.0"
