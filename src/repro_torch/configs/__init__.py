"""Architecture registry: --arch <id> resolves here (counterpart of
``repro.configs``): the LM, GNN and recsys architectures of the
reference."""
from . import (dimenet, equiformer_v2, fm, gatedgcn, gin_tu,
               llama4_maverick_400b, minicpm3_4b, mistral_large_123b,
               mixtral_8x7b, piuma_graph, qwen3_14b)
from .common import (ArchConfig, SpecBundle, apply_variant, init_params,
                     input_specs, make_step, param_logical_axes,
                     param_shardings, shape_names, state_logical_axes,
                     state_shapes)

_REGISTRY = {
    "mistral-large-123b": mistral_large_123b.config,
    "qwen3-14b": qwen3_14b.config,
    "minicpm3-4b": minicpm3_4b.config,
    "llama4-maverick-400b-a17b": llama4_maverick_400b.config,
    "mixtral-8x7b": mixtral_8x7b.config,
    "equiformer-v2": equiformer_v2.config,
    "dimenet": dimenet.config,
    "gatedgcn": gatedgcn.config,
    "gin-tu": gin_tu.config,
    "fm": fm.config,
}

ARCH_NAMES = list(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    return _REGISTRY[name]()
