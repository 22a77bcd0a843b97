"""The port's tunable-parameter space: defaults, sweep grids and the
admissibility rule of a kernel candidate (counterpart of
``repro.tune.space``).

``DEFAULTS`` is what the resolver falls back to when no tuned entry
matches; ``GRIDS`` and ``HYSTERESIS`` are the reference's, value for value,
so the CPU cost models score the same candidates the same way.  The
reference filters BBCSR candidates by a TPU VMEM model; the port admits a
candidate when the CUDA product kernel's shared memory for its
``block_rows`` fits one CTA (:func:`bbcsr_smem_bytes`).

Stdlib only: the resolver imports it on every call site's path.
"""
from __future__ import annotations

__all__ = ["DEFAULTS", "GRIDS", "HYSTERESIS", "SMEM_LIMIT",
           "bbcsr_smem_bytes", "kernel_grid"]

DEFAULTS = {
    # BBCSR tile geometry per kernel family: 'add' is val*msg (spmv_dma,
    # spmspv_dma combine='add'); 'min' is the (min,+)/(max,+) relaxation.
    "kernels.bbcsr_add.block_rows": 256,
    "kernels.bbcsr_add.block_cols": 512,
    "kernels.bbcsr_add.tile_nnz": 512,
    "kernels.bbcsr_min.block_rows": 256,
    "kernels.bbcsr_min.block_cols": 512,
    "kernels.bbcsr_min.tile_nnz": 512,
    # multiplier on the auto_delta histogram quantile (algorithms/sssp).
    "sssp.delta_scale": 1.0,
    # push while |frontier| <= switch_frac * n; the compacted push's routing
    # capacity is m * switch_frac * push_slack
    # (engine.frontier_edge_capacity, which the service's route-byte model
    # prices).
    "engine.switch_frac": 1 / 32,
    "engine.push_slack": 4.0,
    # lanes per GraphService micro-batch.
    "service.batch_budget": 32,
    # The port kernels' own tiles, not the reference's TPU values (512 and
    # 128 there, sized to VMEM and the 128-wide MXU).  segment_sum: the rows
    # plus entries of one merge-path share, which one group of lanes walks
    # (csrc/segment_sum.cu); a row that straddles shares is summed in pieces.
    "kernels.segment_sum.block_n": 512,
    # flash_attention, the folded (decode and f32) paths: block_q is the
    # rows of the folded (query position x group head) space one CTA
    # serves, 16 per warp (16, 32, 64 or 128); block_k the keys per
    # shared-memory tile (32 or 64; csrc/flash_attention.cu).  The bf16
    # wgmma path has its fixed 128 x 128 tile.
    "kernels.flash_attention.block_q": 64,
    "kernels.flash_attention.block_k": 64,
}

# The sweep grids.  The incumbent default is always a candidate, and the
# sweep keeps it unless a challenger wins by more than HYSTERESIS, so a
# tuned entry does not churn on noise.
GRIDS = {
    "kernels.bbcsr_add": {
        "block_rows": (128, 256),
        "block_cols": (256, 512),
        "tile_nnz": (256, 512),
    },
    "kernels.bbcsr_min": {
        "block_rows": (128, 256),
        "block_cols": (256, 512),
        "tile_nnz": (256, 512),
    },
    "engine": {"switch_frac": (1 / 64, 1 / 32, 1 / 16),
               "push_slack": (2.0, 4.0, 8.0)},
    "sssp": {"delta_scale": (0.5, 1.0, 2.0)},
    "service": {"batch_budget": (16, 32, 64)},
}

#: A challenger must beat the incumbent default's cost by this fraction.
HYSTERESIS = 0.10

#: Shared memory one CTA may opt in to on an H100 (bytes).
SMEM_LIMIT = 227 * 1024

# csrc/bbcsr.cu's product kernel: kWarps warps a CTA, each holding a window
# of kWin entries of 5 words and kSlices accumulator rows of block_rows
# floats (warp_words / smem_bytes there; a card test holds this mirror to
# the library's bbcsr_smem_bytes)
_WARPS, _WIN, _SLICES = 8, 128, 2


def bbcsr_smem_bytes(block_rows: int) -> int:
    """Shared memory of one product CTA for ``block_rows``."""
    warp_words = 5 * _WIN + ((_SLICES * int(block_rows) + 1) & ~1)
    return 4 * _WARPS * warp_words


def kernel_grid(section: str):
    """Every candidate dict of a kernel section whose shared memory fits a
    CTA, the default first (the incumbent the hysteresis rule keeps)."""
    grid = GRIDS[section]
    names = sorted(grid)
    default = {n: DEFAULTS[f"{section}.{n}"] for n in names}
    out = [default]
    stack = [{}]
    for name in names:
        stack = [dict(c, **{name: v}) for c in stack for v in grid[name]]
    for cand in stack:
        if cand == default:
            continue
        if section.startswith("kernels.bbcsr") and \
                bbcsr_smem_bytes(cand["block_rows"]) > SMEM_LIMIT:
            continue
        out.append(cand)
    return out
