"""The Lasso λ-path core of the PyTorch port: objective and gap
(``lasso``, ``group_lasso``), the screening rules (``screening``,
``group_screening``), the screening engines (``engine``), the solver
engine with its fista/cd/group_fista strategies (``solver``), the path
driver (``path``) and the session front door (``session``)."""
from .engine import (  # noqa: F401
    DictionaryGeometry,
    GroupDictionaryGeometry,
    GroupScreeningEngine,
    PathWorkspace,
    ScreeningEngine,
)
from .group_lasso import (  # noqa: F401
    group_duality_gap,
    group_gap_from_residual,
    group_lambda_max,
    group_primal,
    group_soft_threshold,
)
from .group_screening import (  # noqa: F401
    GroupDualState,
    group_edpp_mask,
    group_kkt_violations,
    group_spectral_norms,
    group_strong_mask,
)
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
