"""ScreeningEngine: every sphere rule through one streaming pass over X.

X is fixed along the λ-path, so the column norms, |Xᵀy|, λ_max and the
λ_max ray v₁ are λ-independent. :class:`DictionaryGeometry` caches the
query-independent part (X, ‖x_j‖², ‖x_j‖ — one fused
``edpp_screen_scores`` pass with a zero centre at fit);
:class:`PathWorkspace` adds one query (|Xᵀy| from one ``screen_matvec``
pass, λ_max, the argmax feature, v₁). Every sphere screen is then one
``screen_matvec`` pass with the cached norms (``last_x_passes == 1``).

The ops dispatch through :mod:`repro_torch.kernels.ops`: the ``cuda``
backend on the card, the plain ``torch`` versions on the CPU.

The group twins (:class:`GroupDictionaryGeometry`,
:class:`GroupScreeningEngine`) cache the per-group spectral norms ‖X_g‖₂
at fit, λ̄_max and v̄₁ per query, and score every group screen with one
``group_screen_scores`` pass over X.

This is the main subset of ``repro.core.engine``: one query, float32
screens, the sphere rules plus basic SAFE and ``none``, and group EDPP,
group strong and ``none``. The batched workspace (ROADMAP.md queue 1
item 6), the other Lasso rules (item 8), the bf16 screen copy (item 9)
and dictionary updates (item 10) come later.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
from . import group_screening as gscr
from . import screening as scr

#: HBM passes over X that one screen takes through the engine, per rule.
ENGINE_X_PASSES = {"none": 0, "safe": 1}

#: Rules the engine serves in this slice of the port.
ENGINE_RULES = (*scr.SPHERE_RULES, "safe", "none")

#: Rules the group engine serves (the reference's group subset).
GROUP_ENGINE_RULES = (*gscr.GROUP_RULES, "none")


def engine_x_passes(rule: str) -> int:
    """HBM passes over X per screen through the engine (1 for ball rules)."""
    return ENGINE_X_PASSES.get(rule, 1)


def _stream_fit_single(X: torch.Tensor, istar: int, y: torch.Tensor):
    """The λ_max ray v₁ = sign(x*ᵀy)·x* (eq. 17 at λ₀ = λ_max)."""
    xstar = X[:, istar]
    return torch.sign(torch.dot(xstar, y)) * xstar


class DictionaryGeometry:
    """The query-independent geometry of a fitted dictionary X: X on its
    device, ‖x_j‖² and ‖x_j‖. ``_sumsq`` adopts a fit made elsewhere
    (``fit_passes`` then stays 0)."""

    def __init__(self, X: torch.Tensor, backend=None, *, _sumsq=None):
        self.X = X
        self.backend = ops.resolve_backend(backend, X.device)
        self.fit_passes = 0       # fused workspace passes over X
        self.query_passes = 0     # per-query |Xᵀy| attach passes
        if _sumsq is None:
            zero = torch.zeros((X.shape[0],), dtype=X.dtype, device=X.device)
            _, _sumsq = self.backend.fused_scores(X, zero, 0.0)
            self.fit_passes = 1
        self.sumsq = _sumsq
        self.col_norms = torch.sqrt(_sumsq)


class PathWorkspace:
    """A :class:`DictionaryGeometry` plus one query's fit: |Xᵀy|, λ_max,
    the first index attaining it (``istar``) and v₁. Without
    ``geometry`` one fused pass fits X and the query together."""

    def __init__(self, X, y: torch.Tensor, backend=None, *,
                 geometry: DictionaryGeometry | None = None):
        if y.dim() != 1:
            raise NotImplementedError(
                "batched queries come with ROADMAP.md queue 1 item 6")
        if geometry is None:
            backend_r = ops.resolve_backend(backend, X.device)
            scores, sumsq = backend_r.fused_scores(X, y, 0.0)
            geometry = DictionaryGeometry(X, backend_r, _sumsq=sumsq)
            geometry.fit_passes = 1
        else:
            scores = torch.abs(geometry.backend.matvec(geometry.X, y))
        geometry.query_passes += 1
        self.geometry = geometry
        self.backend = geometry.backend
        self.y = y
        self.batch = None
        self.abs_xty = scores
        # torch.argmax returns the first maximal index, like jnp.argmax
        self.istar = int(torch.argmax(scores))
        self.lam_max = float(scores[self.istar])
        self.v1_at_lmax = _stream_fit_single(self.X, self.istar, y)

    @property
    def X(self) -> torch.Tensor:
        return self.geometry.X

    @property
    def sumsq(self) -> torch.Tensor:
        return self.geometry.sumsq

    @property
    def col_norms(self) -> torch.Tensor:
        return self.geometry.col_norms

    def state_at_lambda_max(self) -> scr.DualState:
        """β* = 0, θ* = y/λ_max (eq. 9), from the cache."""
        return scr.DualState(
            theta=self.y / self.lam_max, lam=self.lam_max,
            v1=self.v1_at_lmax, at_lmax=True,
            beta_l1=torch.zeros((), dtype=self.X.dtype, device=self.X.device))


def _at_lmax(lam: float, lmax: float) -> bool:
    """λ ≥ λ_max·(1 − 1e-12), compared in float32 as the reference's
    jitted state builder does."""
    return bool(np.float32(lam) >= np.float32(lmax) * np.float32(1.0 - 1e-12))


class ScreeningEngine:
    """One entry point for every per-step screen on a λ-path::

        eng = ScreeningEngine(X, y, geometry=geom)    # one |Xᵀy| pass
        state = eng.state_at_lambda_max()
        for lam in grid:
            discard = eng.screen(lam, state, rule="edpp")   # one X pass
            ... reduced solve -> beta, fitted = X_r β_r ...
            state = eng.make_state(beta, lam, fitted=fitted)

    ``last_x_passes`` / ``total_x_passes`` / ``last_screen_bytes`` count
    full passes over X (and their bytes) for the path stats.
    """

    def __init__(self, X, y, backend=None, eps: float = scr.EPS_DEFAULT, *,
                 geometry: DictionaryGeometry | None = None):
        self.ws = PathWorkspace(X, y, backend, geometry=geometry)
        self.eps = eps
        self.total_x_passes = 0
        self.last_x_passes = 0
        self.last_screen_bytes = 0.0

    @property
    def lam_max(self) -> float:
        return self.ws.lam_max

    @property
    def geometry(self) -> DictionaryGeometry:
        return self.ws.geometry

    @property
    def backend_name(self) -> str:
        return self.ws.backend.name

    def state_at_lambda_max(self) -> scr.DualState:
        return self.ws.state_at_lambda_max()

    def make_state(self, beta, lam: float, *, fitted=None) -> scr.DualState:
        """Sequential DualState from the solution at λ (KKT eq. 3), with the
        λ_max branch served from the cache. ``fitted`` (= Xβ, from the
        reduced bucket) skips the X·β pass."""
        ws = self.ws
        if _at_lmax(lam, ws.lam_max):
            return ws.state_at_lambda_max()
        if fitted is None:
            fitted = ws.X @ beta
        theta = (ws.y - fitted) / lam
        return scr.DualState(theta=theta, lam=lam, v1=ws.y / lam - theta,
                             at_lmax=False,
                             beta_l1=torch.sum(torch.abs(beta)))

    def _count(self, passes: int) -> None:
        n, p = self.ws.X.shape
        self.last_x_passes = passes
        self.total_x_passes += passes
        self.last_screen_bytes = float(passes) * n * p \
            * self.ws.X.element_size()

    def _sphere_screen(self, test: scr.SphereTest, eps,
                       rule: str) -> torch.Tensor:
        ws = self.ws
        dot = ws.backend.matvec(ws.X, test.centre)
        self._count(engine_x_passes(rule))
        return torch.abs(dot) + test.rho * ws.col_norms < 1.0 - eps

    def screen(self, lam_next: float, state: scr.DualState | None,
               rule: str = "edpp") -> torch.Tensor:
        """Discard mask bool[p] for λ_next: one streaming pass over X."""
        ws = self.ws
        if rule == "none":
            self._count(engine_x_passes(rule))
            return torch.zeros((ws.X.shape[1],), dtype=torch.bool,
                               device=ws.X.device)
        if rule == "safe":
            test = scr.safe_sphere(ws.y, lam_next, ws.lam_max)
            # eq. 15's eps margin is at λ scale: eps/λ once unit-normalised
            return self._sphere_screen(test, self.eps / lam_next, rule)
        if rule not in scr.SPHERE_RULES:
            raise NotImplementedError(
                f"rule {rule!r} is not ported yet (this slice serves "
                f"{ENGINE_RULES}; the rest is ROADMAP.md queue 1 item 8)")
        return self._sphere_screen(
            scr.make_sphere(rule, ws.y, lam_next, state), self.eps, rule)


class GroupDictionaryGeometry:
    """The query-independent geometry of a fitted *group* dictionary: X,
    the group size m and the per-group spectral norms ‖X_g‖₂ (Theorem 20;
    an m × m eigendecomposition per group, the expensive y-independent
    part of group screening). ``_spec_norms`` adopts a fit made elsewhere
    (``fit_passes`` then stays 0)."""

    def __init__(self, X: torch.Tensor, m: int, backend=None, *,
                 _spec_norms=None):
        self.X = X
        self.m = m
        self.backend = ops.resolve_backend(backend, X.device)
        self.fit_passes = 0
        self.query_passes = 0
        if _spec_norms is None:
            _spec_norms = gscr.group_spectral_norms(X, m)
            self.fit_passes = 1
        self.spec_norms = _spec_norms


class GroupScreeningEngine:
    """Group EDPP / group strong screens through the group kernel.

    Caches ‖X_g‖₂ (from the geometry), λ̄_max (one ``group_scores`` pass
    over y) and the λ̄_max ray v̄₁ = X*X*ᵀy once per query; each screen is
    then one ``group_screen_scores`` pass over X."""

    def __init__(self, X, y, m: int, backend=None,
                 eps: float = gscr.EPS_DEFAULT, *,
                 geometry: GroupDictionaryGeometry | None = None):
        if geometry is None:
            geometry = GroupDictionaryGeometry(X, m, backend)
        geometry.query_passes += 1
        self.geometry = geometry
        self.backend = geometry.backend
        self.X = geometry.X
        self.y = y
        self.m = m
        self.eps = eps
        self._state_max = gscr.group_state_at_lambda_max(
            self.X, y, m, scores=self.backend.group_scores)
        self.lam_max = float(self._state_max.lam)
        self.spec_norms = geometry.spec_norms
        self.total_x_passes = 0
        self.last_x_passes = 0
        self.last_screen_bytes = 0.0

    @property
    def backend_name(self) -> str:
        return self.backend.name

    def state_at_lambda_max(self) -> gscr.GroupDualState:
        return self._state_max

    def make_state(self, beta, lam: float, *,
                   fitted=None) -> gscr.GroupDualState:
        """The sequential state from the solution at λ, with the λ̄_max
        branch served from the cache. ``fitted`` (= Xβ, from the reduced
        bucket) skips the X·β pass."""
        if _at_lmax(lam, self.lam_max):
            return self._state_max
        return gscr.group_state_from_solution(self.X, self.y, beta, lam,
                                              fitted=fitted)

    def _count(self, passes: int) -> None:
        n, p = self.X.shape
        self.last_x_passes = passes
        self.total_x_passes += passes
        self.last_screen_bytes = float(passes) * n * p * self.X.element_size()

    def screen(self, lam_next: float, state: gscr.GroupDualState,
               rule: str = "edpp") -> torch.Tensor:
        """Discard mask bool[G] for λ_next: one pass over X (none for
        ``rule="none"``)."""
        if rule == "none":
            self._count(0)
            return torch.zeros((self.X.shape[1] // self.m,), dtype=torch.bool,
                               device=self.X.device)
        if rule == "strong":
            mask = gscr.group_strong_mask(
                self.X, self.y, lam_next, state, self.m, eps=self.eps,
                scores=self.backend.group_scores)
        elif rule == "edpp":
            mask = gscr.group_edpp_mask(
                self.X, self.y, lam_next, state, self.m,
                spec_norms=self.spec_norms, eps=self.eps,
                scores=self.backend.group_scores)
        else:
            raise ValueError(f"group screens take rules "
                             f"{GROUP_ENGINE_RULES}, got {rule!r}")
        self._count(1)
        return mask
