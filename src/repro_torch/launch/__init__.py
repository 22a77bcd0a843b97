"""Launch helpers: the process mesh of the distributed placement and the
serving entry point (``python -m repro_torch.launch.serve``)."""
