"""Launch layer: the solve and serve entry points (``python -m
repro_torch.launch.solve``, ``python -m repro_torch.launch.serve``), their
shared flags (``cli``), the continuous-batching control plane
(``serve_loop``), LM training (``train``, ``mesh``) and the dry run
(``python -m repro_torch.launch.dryrun``: ``specs``, ``hlo``,
``hlo_cost``)."""
