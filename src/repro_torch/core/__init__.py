"""The Lasso λ-path core of the PyTorch port: objective and gap
(``lasso``, ``group_lasso``), the screening rules (``screening``,
``group_screening``), the screening engines and the backend registry
(``engine``), the solver engine with its fista/cd/group_fista strategies
and their batched twins, and the one-shot solvers (``solver``), the path
driver for one query or a batch and the deprecated path functions
(``path``), the session front door (``session``), dictionary updates
(``update``), the feature-sharded ops over ``torch.distributed``
(``distributed``, used as a module, as in the reference) and the solver
loops it replays from CUDA graphs (``graphs``).

Every public name of the reference's ``repro.core`` imports from here
(``tests/test_torch_surface.py`` holds the list)."""
from . import distributed  # noqa: F401
from .engine import (  # noqa: F401
    DictionaryGeometry,
    GroupDictionaryGeometry,
    GroupScreeningEngine,
    PathWorkspace,
    ScreeningEngine,
    available_backends,
    block_scores,
    default_backend,
    engine_x_passes,
    oracle_x_passes,
    register_backend,
    resolve_backend,
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
    group_screen,
    group_spectral_norms,
    group_state_at_lambda_max,
    group_state_from_solution,
    group_strong_mask,
    group_v2_perp,
    make_group_dual_state,
)
from .lasso import (  # noqa: F401
    dual_objective,
    duality_gap,
    feasible_dual_point,
    gap_from_residual,
    power_iteration,
    primal_objective,
    soft_threshold,
    top_eigenpair,
)
from .path import (  # noqa: F401
    PathResult,
    PathStepStats,
    group_lasso_path,
    lambda_grid,
    lasso_path,
    lasso_path_batched,
    next_pow2,
)
from .screening import (  # noqa: F401
    CUT_RULES,
    EPS_DEFAULT,
    HEURISTIC_RULES,
    RULES,
    SAFE_RULES,
    SPHERE_RULES,
    DualState,
    HalfSpaceCut,
    SphereTest,
    cut_from_ray,
    cut_mask,
    dome_mask,
    dpp_mask,
    dpp_sphere,
    edpp_cut_mask,
    edpp_mask,
    edpp_sphere,
    feasibility_cut,
    gap_cut_mask,
    gap_mask,
    gap_sphere,
    halfspace_sup,
    imp1_mask,
    imp1_sphere,
    imp2_mask,
    imp2_sphere,
    kkt_violations,
    lambda_max,
    make_dual_state,
    make_sphere,
    safe_mask,
    safe_sphere,
    screen,
    seq_safe_mask,
    seq_safe_sphere,
    sphere_mask,
    strong_mask,
    v2_perp,
)
from .session import (  # noqa: F401
    GroupPathConfig,
    LassoSession,
    PathConfig,
    ScreenSpec,
    SolveSpec,
)
from .solver import (  # noqa: F401
    BATCHED_SOLVERS,
    SOLVERS,
    FistaResult,
    GroupFistaResult,
    SolveResult,
    SolverEngine,
    available_solvers,
    cd,
    default_solver_backend,
    fista,
    group_fista,
    register_solver,
    resolve_solver_backend,
)
from .update import (  # noqa: F401
    UpdatePlan,
    UpdateReport,
    carry_mask,
    make_plan,
    update_workspace,
)
