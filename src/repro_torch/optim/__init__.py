"""Optimizers of the training path: AdamW (clipping by the whole
gradient's norm over a mesh) and gradient compression for the
data-parallel all-reduce."""
from . import compression
from .adamw import (AdamWConfig, TrainState, apply_update, cosine_schedule,
                    init_state, init_state_with_dtype)
