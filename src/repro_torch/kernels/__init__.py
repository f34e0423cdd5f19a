"""Kernels of the PyTorch port, each beside its plain PyTorch version.

  edpp_screen.py   fused |Xᵀc| + ρ‖x_j‖ scores and the screening matvec
  solver_step.py   fused FISTA iteration (gradient pass + prox + momentum),
                   the Gram coordinate-descent sweep and the FISTA prox
                   and momentum over p-vectors, given g
  group_screen.py  group scores ‖X_gᵀc‖ over contiguous groups
  ref.py           the plain versions (CPU route and on-card yardstick)
  build.py         nvcc build of csrc/*.cu on first use, loaded via ctypes
  ops.py           the ``cuda`` / ``torch`` backend registry
"""
from .edpp_screen import edpp_screen_scores, screen_matvec  # noqa: F401
from .group_screen import group_screen_scores  # noqa: F401
from .ops import (  # noqa: F401
    BACKENDS,
    ScreenBackend,
    launch_counts,
    plain_counts,
    reset_counts,
    resolve_backend,
)
from .solver_step import (  # noqa: F401
    GRAM_BUCKET_MAX,
    cd_gram_sweep,
    fista_step,
    prox_step,
)
