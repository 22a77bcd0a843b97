"""Launch helpers: the process mesh of the distributed placement."""
