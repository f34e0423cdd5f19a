"""LassoSession: fit a dictionary once, solve λ-paths against it.

    sess = LassoSession.fit(X)                 # on the card; one fused pass
    res  = sess.path(y)                        # (n,) query -> B = 1 result
    cpu  = LassoSession.fit(X, device="cpu")   # plain versions on the CPU
    grp  = LassoSession.fit(X, groups=m)       # group Lasso, groups of m

The session owns the fitted :class:`~.engine.DictionaryGeometry` (with
``groups=m``: :class:`~.engine.GroupDictionaryGeometry`) per backend
(the fit runs exactly once per session — ``fit_passes``; each query
attaches with one pass over X — ``query_passes``), the resolved
backends, and the per-bucket Lipschitz eigenvector cache shared by every
:class:`~.solver.SolverEngine` it builds. Configs are the reference's
:class:`ScreenSpec` + :class:`SolveSpec` composed into one
:class:`PathConfig`, with the same fields, defaults, validation and
legacy flat keywords.

This slice of the port serves one (n,) query with the sphere rules,
basic SAFE and ``none``, float32 screens and the ``fista`` and ``cd``
strategies; and, on a session fitted with ``groups=m``, group EDPP,
group strong and ``none`` with the ``group_fista`` strategy. Everything
else raises ``NotImplementedError`` naming the ROADMAP.md item (queue 1)
that brings it.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``cuda``, and raises when no card is present.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..kernels import ops
from . import group_screening as gscr
from . import screening as scr
from .engine import (ENGINE_RULES, GROUP_ENGINE_RULES, DictionaryGeometry,
                     GroupDictionaryGeometry, GroupScreeningEngine,
                     ScreeningEngine)
from .path import PathResult, _path_driver, lambda_grid
from .solver import GROUP_SOLVERS, SOLVERS, SolverEngine

# Every rule the reference knows; ENGINE_RULES are the ones ported so far
# for the Lasso, GROUP_ENGINE_RULES (the reference's group subset) for
# groups.
KNOWN_RULES = ("dpp", "imp1", "imp2", "edpp", "seq_safe", "gap", "strong",
               *(f"{b}_cut" for b in ("dpp", "imp1", "imp2", "edpp",
                                      "seq_safe", "gap")),
               "safe", "dome", "none")


def _not_yet(what: str, item: int, title: str):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1 item {item} "
        f"({title})")


def _check_session_kind(cfg: "PathConfig", m: int) -> None:
    """A group session (m > 1) serves only GROUP_ENGINE_RULES and solves
    with a group strategy; a plain-Lasso session takes no group strategy.
    Anything else would run one problem's rule or solver on the other's
    buckets and return a wrong β under the right name."""
    strategy = cfg.solve.resolved_strategy(m)
    if m > 1:
        if cfg.screen.rule not in GROUP_ENGINE_RULES:
            raise ValueError(f"group sessions support rules "
                             f"{GROUP_ENGINE_RULES}, got {cfg.screen.rule!r}")
        if strategy not in GROUP_SOLVERS:
            raise ValueError(f"group sessions solve with {GROUP_SOLVERS}, "
                             f"got strategy {strategy!r}")
    elif strategy in GROUP_SOLVERS:
        raise ValueError(f"strategy {strategy!r} solves the group Lasso: fit "
                         f"the session with groups=m")


def _check_backend(name, what: str) -> None:
    if name is None or isinstance(name, ops.ScreenBackend):
        return
    if name not in ops.BACKENDS:
        raise ValueError(f"unknown {what} backend {name!r}; available: "
                         f"{tuple(ops.BACKENDS)}")


@dataclasses.dataclass(frozen=True)
class ScreenSpec:
    """Which screening rule runs, where, and how it is backstopped."""

    rule: str = "edpp"
    backend: str | ops.ScreenBackend | None = None  # None: follow the device
    sequential: bool = True       # False = "basic" variants (state at λmax)
    strong: bool = False          # hybrid safe+strong toggle
    eps: float = scr.EPS_DEFAULT
    paranoid: bool = False        # run the KKT loop even for safe rules
    kkt_tol: float = 1e-4
    max_kkt_rounds: int = 10
    screen_dtype: str = "float32"

    def __post_init__(self):
        if self.rule not in KNOWN_RULES:
            raise ValueError(f"unknown screening rule {self.rule!r}; "
                             f"available: {KNOWN_RULES}")
        _check_backend(self.backend, "screening")
        if self.eps < 0:
            raise ValueError(f"eps must be ≥ 0, got {self.eps}")
        if self.kkt_tol <= 0:
            raise ValueError(f"kkt_tol must be > 0, got {self.kkt_tol}")
        if self.max_kkt_rounds < 0:
            raise ValueError("max_kkt_rounds must be ≥ 0")
        if self.screen_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"screen_dtype must be 'float32' or 'bfloat16', "
                             f"got {self.screen_dtype!r}")
        # "strong" serves group sessions; on a plain-Lasso path it raises
        if self.rule not in ENGINE_RULES + GROUP_ENGINE_RULES:
            raise _not_yet(f"screening rule {self.rule!r}", 8,
                           "the other screening rules")
        if self.strong:
            raise _not_yet("hybrid strong screening", 8,
                           "the other screening rules")
        if self.screen_dtype != "float32":
            raise _not_yet("screen_dtype='bfloat16'", 9, "mixed precision")


@dataclasses.dataclass(frozen=True)
class SolveSpec:
    """The solver for the reduced problems. ``strategy=None`` resolves to
    ``fista``, or ``group_fista`` on a session fitted with ``groups=m``;
    ``bucket_min=None`` to 32 features or 16 groups."""

    strategy: str | None = None
    backend: str | ops.ScreenBackend | None = None  # None: follow the device
    tol: float = 1e-8             # relative duality-gap stop
    max_iter: int = 5000
    gap_check_cadence: int = 10   # duality-gap check every k iterations
    bucket_min: int | None = None
    solve_dtype: str = "float32"

    def __post_init__(self):
        if self.strategy is not None and self.strategy not in SOLVERS:
            raise ValueError(f"unknown solver strategy {self.strategy!r}; "
                             f"available: {tuple(SOLVERS)}")
        _check_backend(self.backend, "solver")
        if not self.tol > 0:
            raise ValueError(f"tol must be > 0, got {self.tol}")
        if self.max_iter < 1:
            raise ValueError("max_iter must be ≥ 1")
        if self.gap_check_cadence < 1:
            raise ValueError("gap_check_cadence must be ≥ 1")
        if self.bucket_min is not None and self.bucket_min < 1:
            raise ValueError("bucket_min must be ≥ 1")
        if self.solve_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"solve_dtype must be 'float32' or 'bfloat16', "
                             f"got {self.solve_dtype!r}")
        if self.solve_dtype != "float32":
            raise _not_yet("solve_dtype='bfloat16'", 9, "mixed precision")

    def resolved_strategy(self, m: int = 1) -> str:
        return self.strategy or ("group_fista" if m > 1 else "fista")


_SCREEN_KW = {
    "rule": "rule", "backend": "backend", "sequential": "sequential",
    "eps": "eps", "paranoid": "paranoid", "kkt_tol": "kkt_tol",
    "max_kkt_rounds": "max_kkt_rounds", "hybrid_strong": "strong",
    "screen_dtype": "screen_dtype",
}
_SOLVE_KW = {
    "solver": "strategy", "solver_backend": "backend", "solver_tol": "tol",
    "max_iter": "max_iter", "gap_check_cadence": "gap_check_cadence",
    "bucket_min": "bucket_min", "solve_dtype": "solve_dtype",
}


@dataclasses.dataclass(frozen=True, init=False)
class PathConfig:
    """A :class:`ScreenSpec` + a :class:`SolveSpec` (+ an optional per-step
    checkpoint hook). The reference's flat keywords (``rule=``,
    ``solver_tol=``, …) route into the specs."""

    screen: ScreenSpec
    solve: SolveSpec
    checkpoint_fn: Callable | None  # called with (k, lam, beta) per step

    def __init__(self, screen: ScreenSpec | None = None,
                 solve: SolveSpec | None = None,
                 checkpoint_fn: Callable | None = None, **legacy):
        screen = screen if screen is not None else ScreenSpec()
        solve = solve if solve is not None else SolveSpec()
        if not isinstance(screen, ScreenSpec):
            raise TypeError(f"screen must be a ScreenSpec, got {screen!r}")
        if not isinstance(solve, SolveSpec):
            raise TypeError(f"solve must be a SolveSpec, got {solve!r}")
        s_kw, v_kw = {}, {}
        for k, v in legacy.items():
            if k in _SCREEN_KW:
                s_kw[_SCREEN_KW[k]] = v
            elif k in _SOLVE_KW:
                v_kw[_SOLVE_KW[k]] = v
            else:
                raise TypeError(f"PathConfig got an unknown field {k!r}")
        if s_kw:
            screen = dataclasses.replace(screen, **s_kw)
        if v_kw:
            solve = dataclasses.replace(solve, **v_kw)
        object.__setattr__(self, "screen", screen)
        object.__setattr__(self, "solve", solve)
        object.__setattr__(self, "checkpoint_fn", checkpoint_fn)

    # the flat fields the path driver reads
    rule = property(lambda self: self.screen.rule)
    sequential = property(lambda self: self.screen.sequential)
    max_kkt_rounds = property(lambda self: self.screen.max_kkt_rounds)
    bucket_min = property(lambda self: self.solve.bucket_min)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one, raise instead of silently
    running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU unless asked otherwise, and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev


def as_tensor(a, device: torch.device, dtype=None) -> torch.Tensor:
    """Host or device array → contiguous tensor on ``device``. Float64
    numpy input becomes float32, as ``jnp.asarray`` does without x64; a
    float64 tensor stays float64 (solved with the plain versions)."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        arr = np.asarray(a)
        if dtype is None and arr.dtype != np.float32:
            arr = arr.astype(np.float32)
        if not arr.flags.writeable:      # e.g. a view of a jax array
            arr = arr.copy()
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


class LassoSession:
    """A fitted dictionary + resolved engine choices; query it many times.
    Construct with :meth:`fit` (or :func:`repro_torch.convert.
    session_from_arrays` to adopt a fit made elsewhere)."""

    def __init__(self, *a, **k):
        raise TypeError("LassoSession is constructed with "
                        "LassoSession.fit(X, ...)")

    @classmethod
    def _new(cls, X: torch.Tensor, cfg: PathConfig,
             m: int = 1) -> "LassoSession":
        if X.shape[1] % m:
            raise ValueError(f"p={X.shape[1]} is not divisible by "
                             f"groups={m}")
        _check_session_kind(cfg, m)
        self = object.__new__(cls)
        self.config = cfg
        self.groups = m
        self.X = X
        self.device = X.device
        self._geometries: dict[str, object] = {}
        self._eig_cache: dict[int, torch.Tensor] = {}
        self._eig_stats = {"warm": 0, "cold": 0}
        self._default_backend = ops.resolve_backend(
            cfg.screen.backend, X.device).name
        return self

    @classmethod
    def fit(cls, X, *, groups: int | None = None, mesh=None,
            config: PathConfig | None = None,
            device=None) -> "LassoSession":
        """Fit the dictionary side once: X to the device, then one fused
        ``edpp_screen_scores`` pass for ‖x_j‖² — or, with ``groups=m``
        (contiguous groups of m columns), the per-group spectral norms for
        every later group path. ``device=None`` is the card; pass
        ``device="cpu"`` for the CPU."""
        cfg = config if config is not None else PathConfig()
        if not isinstance(cfg, PathConfig):
            raise TypeError(f"config must be a PathConfig, got "
                            f"{type(cfg).__name__}")
        m = 1 if groups is None else int(groups)
        if m < 1:
            raise ValueError(f"groups must be ≥ 1, got {groups}")
        if mesh is not None:
            raise _not_yet("mesh=", 13, "distributed")
        Xt = as_tensor(X, resolve_device(device))
        if Xt.dim() != 2:
            raise ValueError(f"X must be (n, p), got shape {tuple(Xt.shape)}")
        self = cls._new(Xt, cfg, m)
        self._geometry(self._default_backend)     # the one fit
        return self

    def _geometry(self, backend=None):
        """The fitted (group) geometry for a backend, built on first use."""
        inst = ops.resolve_backend(
            backend if backend is not None else self._default_backend,
            self.device)
        geom = self._geometries.get(inst.name)
        if geom is None:
            geom = (GroupDictionaryGeometry(self.X, self.groups, inst)
                    if self.groups > 1 else DictionaryGeometry(self.X, inst))
            self._geometries[inst.name] = geom
        return geom

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.X.shape)

    @property
    def geometry(self):
        return self._geometries[self._default_backend]

    @property
    def backend_name(self) -> str:
        return self._default_backend

    @property
    def fit_passes(self) -> int:
        """Fit passes over X: one per (backend, session)."""
        return sum(g.fit_passes for g in self._geometries.values())

    @property
    def query_passes(self) -> int:
        """Per-query attach passes, |Xᵀy| or ‖X_gᵀy‖ (one per ``path``)."""
        return sum(g.query_passes for g in self._geometries.values())

    def reset_solver_cache(self) -> None:
        """Drop the warm-started per-bucket Lipschitz eigenvectors, so the
        next solves start cold from the seed (bitwise replay)."""
        self._eig_cache.clear()

    def update(self, add=None, drop=None, *, workspaces=()):
        """Edit the fitted dictionary in place (reference
        ``session.update``)."""
        if self.groups > 1:
            raise NotImplementedError(
                "session.update is plain-Lasso only: group geometries "
                "cache per-group spectral norms that a column edit "
                "invalidates wholesale — refit instead")
        raise _not_yet("session.update", 10, "incremental dictionaries")

    def path(self, Y, lambdas=None, *, num_lambdas: int = 100,
             lo_frac: float = 0.05, hi_frac: float = 1.0,
             config: PathConfig | None = None) -> PathResult:
        """Solve the λ-path for one (n,) query with screening; a session
        fitted with ``groups=m`` runs the group path. ``lambdas`` is a
        decreasing (K,) grid, or None for
        ``lambda_grid(λ_max, num_lambdas, lo_frac, hi_frac)``. Returns the
        :class:`PathResult` with its leading batch axis (B = 1)."""
        cfg = config if config is not None else self.config
        if not isinstance(cfg, PathConfig):
            raise TypeError(f"config must be a PathConfig, got "
                            f"{type(cfg).__name__}")
        _check_session_kind(cfg, self.groups)   # per-call overrides too
        y = as_tensor(Y, self.device, self.X.dtype)
        if y.dim() == 2:
            raise _not_yet("a (B, n) query batch", 6, "batched multi-query "
                           "path")
        if y.dim() != 1 or y.shape[0] != self.X.shape[0]:
            raise ValueError(f"query must be ({self.X.shape[0]},), got "
                             f"shape {tuple(y.shape)}")
        grid_kw = dict(num=num_lambdas, lo_frac=lo_frac, hi_frac=hi_frac)
        if self.groups > 1:
            return self._group_path(y, lambdas, cfg, grid_kw)
        if cfg.screen.rule == "strong":
            raise _not_yet("screening rule 'strong' on a plain-Lasso path",
                           8, "the other screening rules")
        return self._lasso_path(y, lambdas, cfg, grid_kw)

    def _solver_engine(self, y, cfg: PathConfig) -> SolverEngine:
        return SolverEngine(
            y, solver=cfg.solve.resolved_strategy(self.groups),
            backend=cfg.solve.backend, tol=cfg.solve.tol,
            max_iter=cfg.solve.max_iter,
            gap_check_cadence=cfg.solve.gap_check_cadence,
            eig_cache=self._eig_cache, eig_stats=self._eig_stats)

    def _need_kkt(self, cfg: PathConfig) -> bool:
        """The KKT loop backs the heuristic group strong rule (and runs
        when ``paranoid`` asks for it)."""
        heuristic = self.groups > 1 and cfg.screen.rule == "strong"
        return heuristic or cfg.screen.paranoid

    def _lasso_path(self, y, lambdas, cfg, grid_kw) -> PathResult:
        eng = ScreeningEngine(self.X, y, eps=cfg.screen.eps,
                              geometry=self._geometry(cfg.screen.backend))
        if lambdas is None:
            lambdas = lambda_grid(eng.lam_max, **grid_kw)
        X = self.X

        def kkt_fn(beta_full, lam, discard, fitted=None):
            return scr.kkt_violations(X, y, beta_full, lam, discard,
                                      cfg.screen.kkt_tol, fitted)

        return _path_driver(X, y, lambdas, cfg, screen_engine=eng,
                            solver_engine=self._solver_engine(y, cfg),
                            need_kkt=self._need_kkt(cfg), kkt_fn=kkt_fn)

    def _group_path(self, y, lambdas, cfg, grid_kw) -> PathResult:
        m = self.groups
        eng = GroupScreeningEngine(self.X, y, m, eps=cfg.screen.eps,
                                   geometry=self._geometry(cfg.screen.backend))
        if lambdas is None:
            lambdas = lambda_grid(eng.lam_max, **grid_kw)
        X = self.X

        def kkt_fn(beta_full, lam, discard, fitted=None):
            return gscr.group_kkt_violations(X, y, beta_full, lam, discard, m,
                                             cfg.screen.kkt_tol, fitted)

        return _path_driver(X, y, lambdas, cfg, m=m, screen_engine=eng,
                            solver_engine=self._solver_engine(y, cfg),
                            need_kkt=self._need_kkt(cfg), kkt_fn=kkt_fn)
