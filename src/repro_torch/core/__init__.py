"""PIUMA core on torch: graph substrate (with community contraction) and
its epoch-versioned handle, local offload engines (the structured segment
combines among them), the direction-optimizing engine and its algorithms
(one device; scalar, valued and bit-packed lanes, and the structured
'argmax_weighted' / 'sample' combines), the route-byte traffic model and
the local graph query service."""
from . import engine, graph, offload, traffic
from .graph import (CSR, BBCSR, GraphHandle, UpdateReport, rmat,
                    uniform_random_graph, to_padded_ell, to_bbcsr,
                    csr_from_numpy, bbcsr_from_numpy, contract)
from .service import (Distance, GraphService, NeighborSample, PPRTopK,
                      Reachability, ServiceStats, load_cost_priors)
