"""Synthetic data pipelines, byte-equal to the reference's for a seed."""
from . import synthetic
