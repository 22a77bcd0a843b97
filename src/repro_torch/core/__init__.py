"""PIUMA core on torch: graph substrate, local offload engines, the
direction-optimizing engine and its algorithms (one device; scalar, valued
and bit-packed lanes)."""
from . import engine, graph, offload
from .graph import (CSR, BBCSR, rmat, uniform_random_graph, to_padded_ell,
                    to_bbcsr, csr_from_numpy, bbcsr_from_numpy)
