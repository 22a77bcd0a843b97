"""Checkpoints of a training state, in the reference's on-disk format."""
from .ckpt import CheckpointManager, latest_step, restore, save
