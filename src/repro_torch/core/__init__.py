"""The Lasso λ-path core of the PyTorch port: objective and gap
(``lasso``), the sphere screening rules (``screening``), the screening
engine (``engine``), the FISTA solver engine (``solver``), the path
driver (``path``) and the session front door (``session``)."""
from .engine import DictionaryGeometry, PathWorkspace, ScreeningEngine  # noqa: F401
from .lasso import (  # noqa: F401
    duality_gap,
    gap_from_residual,
    power_iteration,
    soft_threshold,
    top_eigenpair,
)
from .path import PathResult, PathStepStats, lambda_grid  # noqa: F401
from .screening import (  # noqa: F401
    DualState,
    SphereTest,
    edpp_mask,
    kkt_violations,
    lambda_max,
    make_dual_state,
    screen,
    v2_perp,
)
from .session import LassoSession, PathConfig, ScreenSpec, SolveSpec  # noqa: F401
from .solver import SOLVERS, SolveResult, SolverEngine, register_solver  # noqa: F401
