"""Launch helpers: the process mesh of the distributed placement and the
serving and training entry points (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``)."""
