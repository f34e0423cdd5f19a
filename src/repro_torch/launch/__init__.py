"""Launch layer: the solve and serve entry points (``python -m
repro_torch.launch.solve``, ``python -m repro_torch.launch.serve``), their
shared flags (``cli``) and the continuous-batching control plane
(``serve_loop``)."""
