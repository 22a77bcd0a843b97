"""Optimizers of the training path (one device; gradient compression over
a data-parallel axis waits for rules over a mesh)."""
from .adamw import (AdamWConfig, TrainState, apply_update, cosine_schedule,
                    init_state, init_state_with_dtype)
