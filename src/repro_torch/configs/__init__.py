"""Architecture registry: --arch <id> resolves here (counterpart of
``repro.configs``).  The LM and recsys architectures; the four GNN names
(equiformer-v2, dimenet, gatedgcn, gin-tu) join with ``models.gnn`` in the
training slice (ROADMAP §A.9), and ``get_config`` raises KeyError for them
until then."""
from . import (fm, llama4_maverick_400b, minicpm3_4b, mistral_large_123b,
               mixtral_8x7b, piuma_graph, qwen3_14b)
from .common import (ArchConfig, SpecBundle, apply_variant, init_params,
                     input_specs, make_step, param_shardings, shape_names,
                     state_logical_axes, state_shapes)

_REGISTRY = {
    "mistral-large-123b": mistral_large_123b.config,
    "qwen3-14b": qwen3_14b.config,
    "minicpm3-4b": minicpm3_4b.config,
    "llama4-maverick-400b-a17b": llama4_maverick_400b.config,
    "mixtral-8x7b": mixtral_8x7b.config,
    "fm": fm.config,
}
# GNN architectures of the reference, not ported yet
PENDING = ("equiformer-v2", "dimenet", "gatedgcn", "gin-tu")

ARCH_NAMES = list(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name in PENDING:
        raise KeyError(f"arch {name!r} needs models.gnn (GNNConfig), which "
                       f"comes with the training slice (ROADMAP §A.9)")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return _REGISTRY[name]()
