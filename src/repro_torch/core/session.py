"""LassoSession: fit a dictionary once, solve λ-paths against it.

    sess = LassoSession.fit(X)                 # on the card; one fused pass
    res  = sess.path(y)                        # (n,) query -> B = 1 result
    bat  = sess.path(Y)                        # (B, n) batch -> B results
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

The port serves (n,) queries and (B, n) batches with every Lasso rule
of the reference (the sequential spheres, GAP, the ``*_cut`` composites,
basic SAFE, DOME, the strong rule with its KKT loop, ``none``, and
hybrid safe+strong, ``ScreenSpec(strong=True)``), float32 screens or
bf16 ones (``ScreenSpec(screen_dtype="bfloat16")``: masks bit for bit
the float32 ones), float32 solves or mixed-precision ones
(``SolveSpec(solve_dtype="bfloat16")``: a certified bf16 phase on each
bucket's gather of the same bf16 copy, then a float32 polish; a group
session solves in float32 with a warning) and the ``fista`` and
``cd`` strategies (a batch runs the batched driver:
one screen and one solve a step for all B queries, their kernels
launched once for the batch); on a session fitted with ``groups=m``,
group EDPP, group strong, ``none`` and hybrid group EDPP + group strong
with the ``group_fista`` strategy (a batch loops the single-query group
driver, as the reference does); and, with ``mesh=``
(a :class:`~torch.distributed.device_mesh.DeviceMesh` under an
initialised process group, one process per rank), the same paths on X
split by columns over the mesh's feature axes (every axis but
``"query"``, flattened into one): each rank keeps its column block, the
screens run per block and gather (``backend_name == "shard:<tile>"``),
and each reduced bucket is gathered replicated and solved alike on every
rank (a batch stays whole on every rank), bf16 screens and solves
included; a group session's blocks hold whole groups (m divides p/F) and
its group scores and spectral norms are gathered per block.
``session.update(add=, drop=)`` edits a plain session's dictionary in
place, on and off a mesh (:mod:`.update`); a group session refuses it,
as the reference does.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``cuda``, and raises when no card is present.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np
import torch

from ..kernels import ops
from . import distributed as dist
from . import group_screening as gscr
from . import screening as scr
from .device import as_tensor, resolve_device
from .engine import (ENGINE_RULES, GROUP_ENGINE_RULES, DictionaryGeometry,
                     GroupDictionaryGeometry, GroupScreeningEngine,
                     ScreeningEngine)
from .path import PathResult, PathStepStats, _path_driver, lambda_grid
from .solver import GROUP_SOLVERS, SOLVERS, SolverEngine

# Every Lasso rule the reference knows (GROUP_ENGINE_RULES, the
# reference's group subset, is what a group session takes).
KNOWN_RULES = ENGINE_RULES


def _group_session(cfg: "PathConfig", groups: int | None) -> bool:
    """The kind of a session, decided once at fit: ``groups=m > 1`` is the
    group Lasso, and so is ``groups=1`` with a group strategy named in the
    config (``GroupPathConfig`` at m = 1, as the ``group_lasso_path`` shim
    passes it: groups of one column) when the group screen serves the
    config (a rule of GROUP_ENGINE_RULES, a float32 screen); anything else
    is the plain Lasso, as the reference's every session at m = 1."""
    if groups is None:
        return False
    if int(groups) > 1:
        return True
    return (cfg.solve.strategy in GROUP_SOLVERS
            and cfg.screen.rule in GROUP_ENGINE_RULES
            and cfg.screen.screen_dtype == "float32")


def _check_session_kind(cfg: "PathConfig", m: int, grouped: bool,
                        one_column: bool = False) -> None:
    """A group session serves only GROUP_ENGINE_RULES and solves with a
    group strategy; a plain-Lasso session takes no group strategy, unless
    it was fitted with ``groups=1`` (``one_column``): groups of one column
    are the Lasso, and a group strategy solves it there, as the
    reference's shim does at m = 1. Anything else would run one problem's
    rule or solver on the other's buckets and return a wrong β under the
    right name."""
    strategy = cfg.solve.resolved_strategy(m)
    if grouped:
        if cfg.screen.rule not in GROUP_ENGINE_RULES:
            raise ValueError(f"group sessions support rules "
                             f"{GROUP_ENGINE_RULES}, got {cfg.screen.rule!r}")
        if cfg.screen.screen_dtype != "float32":
            # the group score ‖X_gᵀc‖ has no margin bound (the reference
            # refuses it too)
            raise ValueError(
                "group sessions support screen_dtype='float32' only, got "
                f"{cfg.screen.screen_dtype!r}")
        if strategy not in GROUP_SOLVERS:
            raise ValueError(f"group sessions solve with {GROUP_SOLVERS}, "
                             f"got strategy {strategy!r}")
    elif strategy in GROUP_SOLVERS and not one_column:
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
    hybrid_strong = property(lambda self: self.screen.strong)
    sequential = property(lambda self: self.screen.sequential)
    max_kkt_rounds = property(lambda self: self.screen.max_kkt_rounds)
    bucket_min = property(lambda self: self.solve.bucket_min)


def GroupPathConfig(**kw) -> PathConfig:
    """DEPRECATED: a :class:`PathConfig` with the old group defaults
    (``solver="group_fista"``, ``bucket_min=16`` groups). A plain
    PathConfig passed to ``LassoSession.fit(X, groups=m)`` resolves the
    group defaults by itself."""
    warnings.warn("repro_torch.core.GroupPathConfig is deprecated; use "
                  "PathConfig with LassoSession.fit(X, groups=m)",
                  DeprecationWarning, stacklevel=2)
    kw.setdefault("solver", "group_fista")
    kw.setdefault("bucket_min", 16)
    return PathConfig(**kw)


class LassoSession:
    """A fitted dictionary + resolved engine choices; query it many times.
    Construct with :meth:`fit` (or :func:`repro_torch.convert.
    session_from_arrays` to adopt a fit made elsewhere)."""

    def __init__(self, *a, **k):
        raise TypeError("LassoSession is constructed with "
                        "LassoSession.fit(X, ...)")

    @classmethod
    def _new(cls, X: torch.Tensor, cfg: PathConfig,
             groups: int | None = None, mesh=None) -> "LassoSession":
        m = 1 if groups is None else int(groups)
        if X.shape[1] % m:
            raise ValueError(f"p={X.shape[1]} is not divisible by "
                             f"groups={m}")
        grouped = _group_session(cfg, groups)
        one_column = groups is not None and not grouped
        _check_session_kind(cfg, m, grouped, one_column)
        self = object.__new__(cls)
        self.config = cfg
        self.groups = m
        self.grouped = grouped
        self._one_column = one_column
        self.X = X
        self.mesh = mesh
        self.device = X.device
        self._geometries: dict[str, object] = {}
        self._shard_backends: dict[str, ops.ScreenBackend] = {}
        self._eig_cache: dict[int, torch.Tensor] = {}
        self._eig_stats = {"warm": 0, "cold": 0}
        self._version = 0
        self._default_backend = self._resolve_for_session(
            cfg.screen.backend).name
        return self

    @classmethod
    def fit(cls, X, *, groups: int | None = None, mesh=None,
            config: PathConfig | None = None, device=None,
            geometry: DictionaryGeometry | None = None) -> "LassoSession":
        """Fit the dictionary side once: X to the device, then one fused
        ``edpp_screen_scores`` pass for ‖x_j‖² — or, with ``groups=m``
        (contiguous groups of m columns), the per-group spectral norms for
        every later group path. ``device=None`` is the card; pass
        ``device="cpu"`` for the CPU.

        ``mesh`` (a DeviceMesh of the initialised process group, with
        feature axes and optionally a ``"query"`` axis) keeps this rank's
        column block of X — every rank calls with the same global X — and
        resolves the configured screen backend per block
        (:func:`.distributed.sharded_backend`; an explicit backend is
        honoured); with ``groups=m`` each block must hold whole groups
        (``ValueError`` naming p, m and F otherwise). ``geometry`` adopts
        a prefitted
        :class:`DictionaryGeometry` instead of fitting.

        ``groups=1`` with a group strategy in the config
        (``GroupPathConfig``) and a rule the group screen serves (EDPP,
        strong or none, float32) fits a group session of one-column
        groups: the group screen ``group_screen_scores`` and
        ``group_fista``; the reference runs the plain drivers there.
        Otherwise ``groups=1`` is the plain Lasso, solved by the config's
        strategy (``group_fista`` included, as in the reference)."""
        cfg = config if config is not None else PathConfig()
        if not isinstance(cfg, PathConfig):
            raise TypeError(f"config must be a PathConfig, got "
                            f"{type(cfg).__name__}")
        m = 1 if groups is None else int(groups)
        if m < 1:
            raise ValueError(f"groups must be ≥ 1, got {groups}")
        if geometry is not None:
            if mesh is not None:
                raise ValueError(
                    "mesh= and geometry= cannot be combined: an adopted "
                    "geometry was fitted off the mesh, so its X would "
                    "bypass the column-sharded placement")
            if m > 1:
                raise ValueError("geometry= adoption is for the plain Lasso "
                                 "(groups=None)")
            self = cls._new(geometry.X, cfg)
            self._geometries[geometry.backend.name] = geometry
            self._default_backend = geometry.backend.name
            self._version = getattr(geometry, "version", 0)
            return self
        dev = resolve_device(device)
        if mesh is None:
            Xt = as_tensor(X, dev)
        else:
            Xt = cls._place_on_mesh(X, mesh, m, dev)
        if Xt.dim() != 2:
            raise ValueError(f"X must be (n, p), got shape {tuple(Xt.shape)}")
        self = cls._new(Xt, cfg, groups, mesh)
        self._geometry(self._default_backend)     # the one fit
        return self

    @staticmethod
    def _place_on_mesh(X, mesh, m: int, dev: torch.device) -> torch.Tensor:
        """This rank's column block of X, after refusing what a mesh
        session does not serve: a group session's block must hold whole
        groups (m divides p/F)."""
        if not torch.distributed.is_initialized():
            raise RuntimeError(
                "mesh= needs an initialised process group, and none is up: "
                "call torch.distributed.init_process_group(...) on every "
                "rank and build the mesh with init_device_mesh first")
        if dev.type != mesh.device_type:
            raise ValueError(f"device {dev} does not match the mesh's "
                             f"device type {mesh.device_type!r}")
        if np.ndim(X) != 2:
            raise ValueError(f"X must be (n, p), got shape {np.shape(X)}")
        if dev.type == "cuda" and dev.index is None:
            dev = dist.mesh_device(mesh)
        if m > 1:
            dist.check_groups(mesh, np.shape(X)[1], m)
        return dist.place_dictionary(mesh, X, dev)

    def _resolve_for_session(self, backend) -> ops.ScreenBackend:
        """The backend instance this session runs for a configured one.
        Off the mesh: :func:`~repro_torch.kernels.ops.resolve_backend`. On
        a mesh the tile backend (an explicit one included) is wrapped in
        :func:`.distributed.sharded_backend`, one per tile."""
        if self.mesh is None or (isinstance(backend, ops.ScreenBackend)
                                 and backend.name.startswith("shard:")):
            return ops.resolve_backend(backend, self.device)
        if isinstance(backend, str) and backend.startswith("shard:"):
            backend = backend[len("shard:"):]
        tile = ops.resolve_backend(backend, self.device)
        shard = self._shard_backends.get(tile.name)
        if shard is None:
            shard = dist.sharded_backend(self.mesh, tile)
            self._shard_backends[tile.name] = shard
        return shard

    def _geometry(self, backend=None):
        """The fitted (group) geometry for a backend, built on first use."""
        inst = self._resolve_for_session(
            backend if backend is not None else self._default_backend)
        geom = self._geometries.get(inst.name)
        if geom is None:
            geom = (GroupDictionaryGeometry(self.X, self.groups, inst,
                                            mesh=self.mesh)
                    if self.grouped
                    else DictionaryGeometry(self.X, inst, mesh=self.mesh))
            # a backend fitted after an update joins at the current
            # version (self.X is already the edited X)
            geom.version = self._version
            self._geometries[inst.name] = geom
        return geom

    @property
    def shape(self) -> tuple[int, int]:
        """(n, p) of the global X (on a mesh, X holds this rank's block)."""
        n, p = self.X.shape
        return n, p * (1 if self.mesh is None else dist.feature_size(self.mesh))

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

    @property
    def version(self) -> int:
        """The dictionary version: 0 at ``fit``, +1 per ``update``
        (recorded per step in ``PathStepStats.geometry_version``)."""
        return self._version

    @property
    def eig_cache_stats(self) -> dict:
        """Warm and cold Lipschitz power-iteration starts of this
        session's solves, ``{"warm": int, "cold": int}``: warm starts keep
        hitting across ``update`` (the cached eigenvectors survive an
        edit), and ``reset_solver_cache`` makes the next solves cold."""
        return dict(self._eig_stats)

    def reset_solver_cache(self) -> None:
        """Drop the warm-started per-bucket Lipschitz eigenvectors, so the
        next solves start cold from the seed (bitwise replay)."""
        self._eig_cache.clear()

    def update(self, add=None, drop=None, *, workspaces=()):
        """Edit the fitted dictionary in place: drop columns, add new ones,
        keep every cache that stays valid (the reference's
        ``session.update``).

        Layout (:mod:`.update`): added columns first recycle the dropped
        slots in ascending drop order, leftover adds append at the end,
        leftover drops compact the survivors left (``drop`` indices refer
        to the current version's columns). A balanced edit
        (``len(drop) == add.shape[1]``) moves no column: every geometry
        patches the edited slots only and pays one pass over the added
        block (:meth:`~.engine.DictionaryGeometry.apply_update`). The
        per-bucket Lipschitz eigenvectors stay as warm starts; each live
        :class:`~.engine.PathWorkspace` in ``workspaces`` is refreshed
        (:func:`~.update.update_workspace`).

        Exactness: after ``update`` and ``reset_solver_cache()``, ``path``
        gives the masks of a cold ``fit`` on the edited X bit for bit and
        β within ``beta_err_tol``.

        On a mesh session the edited p must stay divisible by the mesh's
        feature size (pad ``add`` with zero columns: they are inert); a
        balanced edit patches each rank's own slots, a shape-changing one
        moves columns between ranks. Every rank calls with the same
        arguments. The first update copies the fitted arrays before it
        writes (a float32 numpy X fitted on the CPU is shared with the
        caller); re-read ``session.X`` and the geometry's arrays after an
        update. Group sessions refuse. Returns an
        :class:`~.update.UpdateReport`."""
        from .update import UpdateReport, make_plan, update_workspace
        if self.grouped:
            raise NotImplementedError(
                "session.update is plain-Lasso only: group geometries "
                "cache per-group spectral norms that a column edit "
                "invalidates wholesale — refit instead")
        n, p = self.shape
        plan, X_add = make_plan(p, add, drop)
        if X_add is not None and X_add.shape[0] != n:
            raise ValueError(f"add must have n={n} rows, got "
                             f"{X_add.shape[0]}")
        if self.mesh is not None:
            fsize = dist.feature_size(self.mesh)
            if plan.p_new % fsize:
                raise ValueError(
                    f"edited p={plan.p_new} is not divisible by the mesh's "
                    f"feature size {fsize}; pad add= with zero columns to a "
                    f"multiple of {fsize}")
        if X_add is not None:
            # one host-to-device copy, shared by every geometry and
            # workspace
            X_add = as_tensor(X_add, self.device, self.X.dtype)
        for geom in self._geometries.values():
            geom.apply_update(plan, X_add)
        self._version += 1
        self.X = self.geometry.X
        ws_list = list(workspaces)
        rescans = sum(update_workspace(ws, plan, X_add) for ws in ws_list)
        return UpdateReport(
            version=self._version, p=plan.p_new, n_add=plan.n_add,
            n_drop=plan.n_drop, geometries_updated=len(self._geometries),
            eig_buckets_carried=len(self._eig_cache),
            workspaces_updated=len(ws_list), argmax_rescans=rescans)

    def path(self, Y, lambdas=None, *, num_lambdas: int = 100,
             lo_frac: float = 0.05, hi_frac: float = 1.0,
             config: PathConfig | None = None) -> PathResult:
        """Solve the λ-path for one (n,) query or a (B, n) batch with
        screening; a session fitted with ``groups=m`` runs the group path.
        ``lambdas`` is a decreasing grid, (K,) shared or (B, K) per query,
        or None for each query's ``lambda_grid(λ_max, num_lambdas,
        lo_frac, hi_frac)``. Returns the :class:`PathResult` with its
        leading batch axis (B = 1 for an (n,) query)."""
        cfg = config if config is not None else self.config
        if not isinstance(cfg, PathConfig):
            raise TypeError(f"config must be a PathConfig, got "
                            f"{type(cfg).__name__}")
        _check_session_kind(cfg, self.groups,     # per-call overrides too
                            self.grouped, self._one_column)
        y = as_tensor(Y, self.device, self.X.dtype)
        if y.dim() not in (1, 2):
            raise ValueError(f"queries must be (n,) or (B, n), got shape "
                             f"{tuple(y.shape)}")
        if y.shape[-1] != self.X.shape[0]:
            raise ValueError(f"query length {y.shape[-1]} != dictionary rows "
                             f"{self.X.shape[0]}")
        grid_kw = dict(num=num_lambdas, lo_frac=lo_frac, hi_frac=hi_frac)
        if self.grouped:
            if y.dim() == 1:
                return self._group_path(y, lambdas, cfg, grid_kw)
            return self._group_path_batched(y, lambdas, cfg, grid_kw)
        if y.dim() == 1:
            return self._lasso_path(y, lambdas, cfg, grid_kw)
        return self._lasso_path_batched(y, lambdas, cfg, grid_kw)

    def _solver_engine(self, y, cfg: PathConfig) -> SolverEngine:
        return SolverEngine(
            y, solver=cfg.solve.resolved_strategy(self.groups),
            backend=cfg.solve.backend, tol=cfg.solve.tol,
            max_iter=cfg.solve.max_iter,
            gap_check_cadence=cfg.solve.gap_check_cadence,
            solve_dtype=cfg.solve.solve_dtype,
            eig_cache=self._eig_cache, eig_stats=self._eig_stats)

    def _lo_gather(self, cfg: PathConfig, geom):
        """The driver's ``lo_gather`` for ``solve_dtype="bfloat16"`` on a
        plain session (None otherwise): the bucket's columns of the
        geometry's bf16 copy (the one the bf16 screens read, made once;
        on a mesh gathered from the ranks' blocks like the float32
        bucket), the bucket's largest column error and column norm (both
        global); padding columns are zero in all three."""
        if cfg.solve.solve_dtype != "bfloat16" or self.grouped:
            return None
        col_err = geom.screen_err(torch.bfloat16)
        col_norms = geom.col_norms

        def lo_gather(cols, idx, valid, width):
            Xr_lo = geom.copy_columns(torch.bfloat16, cols, width)
            err = torch.amax(col_err.index_select(0, idx) * valid)
            cn = torch.amax(col_norms.index_select(0, idx) * valid)
            return Xr_lo, err, cn

        return lo_gather

    def _need_kkt(self, cfg: PathConfig) -> bool:
        """The KKT loop backs the heuristic strong rule (the Lasso's or the
        group one) and hybrid safe+strong, and runs when ``paranoid`` asks
        for it."""
        rule = cfg.screen.rule
        heuristic = (rule in scr.HEURISTIC_RULES if not self.grouped
                     else rule == "strong")
        hybrid = cfg.screen.strong and rule not in ("strong", "none")
        return heuristic or hybrid or cfg.screen.paranoid

    def _lasso_path(self, y, lambdas, cfg, grid_kw) -> PathResult:
        geom = self._geometry(cfg.screen.backend)
        eng = ScreeningEngine(self.X, y, eps=cfg.screen.eps, geometry=geom,
                              screen_dtype=cfg.screen.screen_dtype)
        if lambdas is None:
            lambdas = lambda_grid(eng.lam_max, **grid_kw)

        def kkt_fn(beta_full, lam, discard, fitted=None):
            r = y - (geom.fitted(beta_full) if fitted is None else fitted)
            return (torch.abs(geom.correlations(r))
                    > lam * (1.0 + cfg.screen.kkt_tol)) & discard

        return _path_driver(self.X, y, lambdas, cfg, screen_engine=eng,
                            solver_engine=self._solver_engine(y, cfg),
                            need_kkt=self._need_kkt(cfg), kkt_fn=kkt_fn,
                            columns=geom.columns,
                            lo_gather=self._lo_gather(cfg, geom))

    def _lasso_path_batched(self, Y, lambdas, cfg, grid_kw) -> PathResult:
        """B queries through the batched driver; a (1, n) batch takes the
        single-query driver (the union machinery only adds overhead there)
        and keeps the batched layout."""
        B = Y.shape[0]
        if B == 1:
            return self._lasso_path(Y[0], _squeeze_grid(lambdas), cfg,
                                    grid_kw)
        geom = self._geometry(cfg.screen.backend)
        eng = ScreeningEngine(self.X, Y, eps=cfg.screen.eps, geometry=geom,
                              screen_dtype=cfg.screen.screen_dtype)
        lambdas = _batch_grids(lambdas, eng.lam_max, grid_kw)
        tol = cfg.screen.kkt_tol

        def kkt_fn(beta_full, lam, discard, fitted=None):
            r = Y - (geom.fitted(beta_full) if fitted is None else fitted)
            thr = torch.tensor(np.asarray(lam) * (1.0 + tol),
                               dtype=r.dtype, device=r.device)
            return (torch.abs(geom.correlations(r)) > thr[:, None]) & discard

        return _path_driver(self.X, Y, lambdas, cfg, screen_engine=eng,
                            solver_engine=self._solver_engine(Y, cfg),
                            need_kkt=self._need_kkt(cfg), kkt_fn=kkt_fn,
                            columns=geom.columns, batch=B,
                            lo_gather=self._lo_gather(cfg, geom))

    def _group_path_batched(self, Y, lambdas, cfg, grid_kw) -> PathResult:
        """B group paths: the single-query group driver once per query
        (there is no batched group kernel, in the reference either), the
        fitted spectral norms shared; the result in the batched layout,
        each step's stats merged over the batch."""
        B = Y.shape[0]
        if B == 1:
            return self._group_path(Y[0], _squeeze_grid(lambdas), cfg,
                                    grid_kw)
        if lambdas is None:
            per_query = [None] * B
        else:
            lam = np.asarray(lambdas, dtype=np.float64)
            per_query = list(np.broadcast_to(lam, (B, lam.shape[-1])))
        results = [self._group_path(Y[b], per_query[b], cfg, grid_kw)
                   for b in range(B)]
        K = results[0].betas.shape[1]
        return PathResult(
            lambdas=np.stack([r.lambdas[0] for r in results]),
            betas=np.stack([r.betas[0] for r in results]),
            stats=[_merge_step_stats([r.stats[k] for r in results])
                   for k in range(K)],
            masks=np.stack([r.masks[0] for r in results]),
            query_converged=np.concatenate([r.query_converged
                                            for r in results]))

    def _group_path(self, y, lambdas, cfg, grid_kw) -> PathResult:
        """One group path. Every read of the global X goes through the
        geometry (on a mesh: the λ̄_max group, each reduced group bucket
        gathered replicated, the KKT check's Xᵀr gathered), so
        ``group_fista`` runs on whole arrays on every rank."""
        m = self.groups
        geom = self._geometry(cfg.screen.backend)
        eng = GroupScreeningEngine(self.X, y, m, eps=cfg.screen.eps,
                                   geometry=geom)
        if lambdas is None:
            lambdas = lambda_grid(eng.lam_max, **grid_kw)
        X = self.X

        def kkt_fn(beta_full, lam, discard, fitted=None):
            if fitted is None:
                fitted = geom.fitted(beta_full)
            return gscr.group_kkt_violations(
                X, y, beta_full, lam, discard, m, cfg.screen.kkt_tol, fitted,
                correlations=geom.correlations)

        return _path_driver(X, y, lambdas, cfg, m=m, screen_engine=eng,
                            solver_engine=self._solver_engine(y, cfg),
                            need_kkt=self._need_kkt(cfg), kkt_fn=kkt_fn,
                            columns=geom.columns)


def _squeeze_grid(lambdas):
    """A (1, K) grid as the (K,) grid of the single-query driver ((K,) and
    None pass through)."""
    if lambdas is None:
        return None
    lam = np.asarray(lambdas, dtype=np.float64)
    return lam[0] if lam.ndim == 2 else lam


def _batch_grids(lambdas, lam_max: np.ndarray, grid_kw) -> np.ndarray:
    """(B, K) grids: None → each query's own ``lambda_grid``; a shared (K,)
    grid → repeated per query."""
    if lambdas is None:
        return np.stack([lambda_grid(float(lm), **grid_kw) for lm in lam_max])
    lam = np.asarray(lambdas, dtype=np.float64)
    if lam.ndim == 1:
        lam = np.broadcast_to(lam, (lam_max.shape[0], lam.shape[0])).copy()
    return lam


def _merge_step_stats(steps: list[PathStepStats]) -> PathStepStats:
    """One grid step's per-query stats as a batch's: additive telemetry
    (times, passes, checks, bytes) summed, worst cases (iterations, gap,
    KKT rounds, bucket) the max, ``n_discarded`` the least any query
    discarded, ``batch_size`` = B (the reference's
    ``_merge_step_stats``)."""
    B = len(steps)
    x_passes = sum(s.x_passes for s in steps)
    return PathStepStats(
        lam=max(s.lam for s in steps),
        n_discarded=min(s.n_discarded for s in steps),
        n_kept=max(s.n_kept for s in steps),
        solver_iters=max(s.solver_iters for s in steps),
        gap=max(s.gap for s in steps),
        kkt_rounds=max(s.kkt_rounds for s in steps),
        screen_time_s=sum(s.screen_time_s for s in steps),
        solve_time_s=sum(s.solve_time_s for s in steps),
        x_passes=x_passes,
        gap_checks=sum(s.gap_checks for s in steps),
        gram_step_frac=float(np.mean([s.gram_step_frac for s in steps])),
        solver_backend=steps[0].solver_backend,
        screen_backend=steps[0].screen_backend,
        bucket=max(s.bucket for s in steps),
        solver_x_passes=sum(s.solver_x_passes for s in steps),
        batch_size=B,
        queries_converged=sum(s.queries_converged for s in steps),
        x_passes_per_query=x_passes / B,
        screen_bytes=sum(s.screen_bytes for s in steps),
        screen_dtype_effective=steps[0].screen_dtype_effective,
        solve_dtype_effective=steps[0].solve_dtype_effective,
        fallback_cols=sum(s.fallback_cols for s in steps),
        solver_lo_iters=sum(s.solver_lo_iters for s in steps),
        solve_bytes=sum(s.solve_bytes for s in steps),
        geometry_version=steps[0].geometry_version)
