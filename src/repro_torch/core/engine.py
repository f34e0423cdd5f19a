"""ScreeningEngine: every screening rule through the streaming matvec.

X is fixed along the λ-path, so the column norms, |Xᵀy|, λ_max and the
λ_max ray v₁ are λ-independent. :class:`DictionaryGeometry` caches the
query-independent part (X, ‖x_j‖², ‖x_j‖ — one fused
``edpp_screen_scores`` pass with a zero centre at fit);
:class:`PathWorkspace` adds one query (|Xᵀy| from one ``screen_matvec``
pass, λ_max, the argmax feature, v₁ and its cut normal ĝ = v₁/‖v₁‖).
Every screen is then one ``screen_matvec`` pass with the cached norms
(``last_x_passes == 1``; two for DOME, none for ``none``).

The ops dispatch through :mod:`repro_torch.kernels.ops`: the ``cuda``
backend on the card, the plain ``torch`` versions on the CPU. On a mesh
(``DictionaryGeometry(..., mesh=)``) X is the rank's column block and
the backend is :func:`.distributed.sharded_backend`, whose dots and norms
come back gathered in global column order: λ_max and its feature
``istar`` are then the global maximum and its lowest global index, and
the λ_max column is gathered from the rank that holds it.

The group twins (:class:`GroupDictionaryGeometry`,
:class:`GroupScreeningEngine`) cache the per-group spectral norms ‖X_g‖₂
at fit, λ̄_max and v̄₁ per query, and score every group screen with one
``group_screen_scores`` pass over X.

A (B, n) query batch fits all B queries with the same one pass (one
``edpp_screen_scores`` launch without a geometry, one ``screen_matvec``
launch with one): ``lam_max`` and ``istar`` become (B,) host arrays, v₁
and ĝ (B, n). A batched screen takes a (B,) λ and streams the same
passes as one query's, each one ``screen_matvec`` call for the whole
batch (``last_x_passes`` counts the batch once). Every per-query scalar
— a sphere's centre and radius, GAP's ‖Xᵀθ₀‖∞ and gap radius, the cut
offset b = 1/‖g‖, DOME's and the cuts' t_b, each threshold — is built
by the rank-1 rule on host-float λ and fresh rows, and the combine is
elementwise, so a batched mask is bit for bit the single query's mask
from the same state.

Rules (the reference's float32 screens): the sequential spheres, GAP
(its feasibility rescale ‖Xᵀθ₀‖∞ from the same matvec as its scores),
basic SAFE, the strong rule, DOME (two passes: the centre's and ĝ's
dots), every ``<base>_cut`` (the centre and the cached cut normal ĝ
stacked into one matvec: one pass), and ``none``; group EDPP, group
strong and ``none`` (rank-1 queries; a group batch loops them, as the
reference does). The bf16 screen copy (ROADMAP.md queue 1 item 9) and
dictionary updates (item 10) come later.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops
from . import distributed as dist
from . import group_screening as gscr
from . import screening as scr

#: HBM passes over X that one screen takes through the engine, per rule:
#: the ``<base>_cut`` rules stack ĝ into the centre's matvec (one pass),
#: DOME streams the centre and ĝ separately (two).
ENGINE_X_PASSES = {"strong": 1, "dome": 2, "none": 0, "safe": 1,
                   **{f"{b}_cut": 1 for b in scr.SPHERE_RULES}}

#: Every Lasso rule the engine serves (the reference's float32 screens).
ENGINE_RULES = (*scr.SPHERE_RULES, *scr.CUT_RULES, "safe", "dome", "strong",
                "none")

#: Rules the group engine serves (the reference's group subset).
GROUP_ENGINE_RULES = (*gscr.GROUP_RULES, "none")


def engine_x_passes(rule: str) -> int:
    """HBM passes over X per screen through the engine (1 for ball rules)."""
    return ENGINE_X_PASSES.get(rule, 1)


def _stream_fit_single(xstar: torch.Tensor, y: torch.Tensor):
    """The λ_max ray v₁ = sign(x*ᵀy)·x* (eq. 17 at λ₀ = λ_max) and its
    feasibility cut (ĝ = v₁/(‖v₁‖ + 1e-30), b = 1/(‖v₁‖ + 1e-30))."""
    v1 = torch.sign(torch.dot(xstar, y)) * xstar
    return v1, scr.cut_from_ray(v1)


def _stream_fit_batched(xstar: torch.Tensor, Y: torch.Tensor):
    """v₁ per query from the (B, n) argmax columns, f32 accumulation, and
    each row's cut from the rank-1 rule (a list of B cuts)."""
    acc = torch.promote_types(xstar.dtype, torch.float32)
    sgn = torch.sign(torch.sum(xstar.to(acc) * Y.to(acc), dim=-1))
    v1 = sgn.to(xstar.dtype)[:, None] * xstar
    return v1, [scr.cut_from_ray(v.clone()) for v in v1]


class DictionaryGeometry:
    """The query-independent geometry of a fitted dictionary X: X on its
    device, ‖x_j‖² and ‖x_j‖ (global, p of them). ``_sumsq`` adopts a fit
    made elsewhere (``fit_passes`` then stays 0). With ``mesh``, X is the
    rank's column block of a global X with ``p`` columns."""

    def __init__(self, X: torch.Tensor, backend=None, *, _sumsq=None,
                 mesh=None):
        self.X = X
        self.mesh = mesh
        self.p = X.shape[1] * (1 if mesh is None else dist.feature_size(mesh))
        self.backend = ops.resolve_backend(backend, X.device)
        self.fit_passes = 0       # fused workspace passes over X
        self.query_passes = 0     # per-query |Xᵀy| attach passes
        if _sumsq is None:
            zero = torch.zeros((X.shape[0],), dtype=X.dtype, device=X.device)
            _, _sumsq = self.backend.fused_scores(X, zero, 0.0)
            self.fit_passes = 1
        self.sumsq = _sumsq
        self.col_norms = torch.sqrt(_sumsq)

    def columns(self, cols, width: int | None = None) -> torch.Tensor:
        """Global columns ``cols`` (host indices) of X as an (n, width)
        block zero-padded past ``len(cols)`` (``width`` defaults to it),
        the same on every rank: the path's reduced buckets."""
        if self.mesh is not None:
            return dist.gather_columns(self.mesh, self.X, cols, width)
        cols = np.asarray(cols, dtype=np.int64)
        out = torch.zeros((self.X.shape[0], cols.size if width is None
                           else width), dtype=self.X.dtype,
                          device=self.X.device)
        out[:, :cols.size] = self.X[:, cols]
        return out

    def correlations(self, r: torch.Tensor) -> torch.Tensor:
        """Xᵀr (p,) for r (n,), or rX (B, p) for r (B, n), in global column
        order, the same on every rank."""
        local = r @ self.X if r.dim() == 2 else self.X.T @ r
        if self.mesh is None:
            return local
        return dist.gather_features(self.mesh, local)

    def fitted(self, beta: torch.Tensor) -> torch.Tensor:
        """Xβ (n,) for a global β (p,), or βXᵀ (B, n) for β (B, p), the
        same on every rank."""
        if self.mesh is None:
            return beta @ self.X.T if beta.dim() == 2 else self.X @ beta
        return dist.fitted_values(self.mesh, self.X, beta)


class PathWorkspace:
    """A :class:`DictionaryGeometry` plus the query fit: |Xᵀy|, λ_max, the
    first index attaining it (``istar``), v₁ and the λ_max feasibility
    cut (``cuts``: one :class:`~.screening.HalfSpaceCut` per query, its
    normal ĝ = v₁/‖v₁‖). Without ``geometry`` one fused pass fits X and
    the query together. ``y`` (B, n) fits a batch in the same one pass:
    ``lam_max`` (float64) and ``istar`` are then (B,) host arrays and v₁
    is (B, n)."""

    def __init__(self, X, y: torch.Tensor, backend=None, *,
                 geometry: DictionaryGeometry | None = None):
        if y.dim() not in (1, 2):
            raise ValueError(f"queries must be (n,) or (B, n), got shape "
                             f"{tuple(y.shape)}")
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
        self.batch = None if y.dim() == 1 else y.shape[0]
        self.abs_xty = scores
        self._state_max = None
        # torch.argmax returns the first maximal index, like jnp.argmax
        if self.batch is None:
            self.istar = int(torch.argmax(scores))
            self.lam_max = float(scores[self.istar])
            self.v1_at_lmax, cut = _stream_fit_single(
                geometry.columns([self.istar])[:, 0], y)
            self.cuts = [cut]
        else:
            istar = torch.argmax(scores, dim=-1)
            self.istar = istar.cpu().numpy()
            self.lam_max = scores.gather(1, istar[:, None])[:, 0].cpu() \
                .numpy().astype(np.float64)
            self.v1_at_lmax, self.cuts = _stream_fit_batched(
                geometry.columns(self.istar).T, y)

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
        """β* = 0, θ* = y/λ_max (eq. 9), from the cache. Batched, each row
        of θ is the single query's y/λ_max (a host-float division)."""
        if self._state_max is not None:
            return self._state_max
        dev, dt = self.X.device, self.X.dtype
        if self.batch is None:
            st = scr.DualState(
                theta=self.y / self.lam_max, lam=self.lam_max,
                v1=self.v1_at_lmax, at_lmax=True,
                beta_l1=torch.zeros((), dtype=dt, device=dev))
        else:
            st = scr.DualState(
                theta=torch.stack([yb / float(lm) for yb, lm
                                   in zip(self.y, self.lam_max)]),
                lam=self.lam_max.copy(), v1=self.v1_at_lmax,
                at_lmax=np.ones((self.batch,), dtype=bool),
                beta_l1=torch.zeros((self.batch,), dtype=dt, device=dev))
        self._state_max = st
        return st


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

    @property
    def p(self) -> int:
        """Columns of the global X."""
        return self.ws.geometry.p

    def state_at_lambda_max(self) -> scr.DualState:
        return self.ws.state_at_lambda_max()

    @property
    def batch(self) -> int | None:
        return self.ws.batch

    def make_state(self, beta, lam, *, fitted=None) -> scr.DualState:
        """Sequential DualState from the solution at λ (KKT eq. 3), with the
        λ_max branch served from the cache. ``fitted`` (= Xβ, from the
        reduced bucket) skips the X·β pass. Batched: β (B, p), λ (B,) host
        values, fitted (B, n); the rows at their λ_max take the cached
        rows (the reference's ``_make_state_batched_fit``)."""
        ws = self.ws
        if ws.batch is not None:
            return self._make_state_batched(beta, lam, fitted)
        if scr.at_lmax(lam, ws.lam_max):
            return ws.state_at_lambda_max()
        if fitted is None:
            fitted = ws.geometry.fitted(beta)
        theta = (ws.y - fitted) / lam
        return scr.DualState(theta=theta, lam=lam, v1=ws.y / lam - theta,
                             at_lmax=False,
                             beta_l1=torch.sum(torch.abs(beta)))

    def _make_state_batched(self, beta, lam, fitted) -> scr.DualState:
        ws = self.ws
        lam = _host_rows(lam)
        at = scr.at_lmax_rows(lam, ws.lam_max)
        st_max = ws.state_at_lambda_max()
        if at.all():
            return st_max
        if fitted is None:
            fitted = ws.geometry.fitted(beta)
        lam_t = torch.as_tensor(lam, dtype=ws.y.dtype,
                                device=ws.y.device)[:, None]
        theta = (ws.y - fitted) / lam_t
        v1 = ws.y / lam_t - theta
        # ‖β‖₁ per row, each summed as a single query's (GAP's radius)
        beta_l1 = torch.stack([torch.sum(torch.abs(b)) for b in beta])
        if at.any():
            at_t = torch.from_numpy(at).to(ws.y.device)
            theta = torch.where(at_t[:, None], st_max.theta, theta)
            v1 = torch.where(at_t[:, None], st_max.v1, v1)
            beta_l1 = torch.where(at_t, st_max.beta_l1, beta_l1)
        return scr.DualState(theta=theta, lam=np.where(at, ws.lam_max, lam),
                             v1=v1, at_lmax=at, beta_l1=beta_l1)

    def _count(self, passes: int) -> None:
        self.last_x_passes = passes
        self.total_x_passes += passes
        self.last_screen_bytes = float(passes) * self.ws.X.shape[0] \
            * self.p * self.ws.X.element_size()

    def _query(self, b: int | None, lam: float, state) -> "_Query":
        """Query b of the batch (None: the single query) at λ, with the
        state the rank-1 rules take: host floats and fresh rows."""
        ws = self.ws
        if b is None:
            return _Query(ws.y, lam, ws.lam_max, state, ws.cuts[0],
                          ws.istar)
        return _Query(ws.y[b].clone(), lam, float(ws.lam_max[b]),
                      None if state is None else state.query(b),
                      ws.cuts[b], int(ws.istar[b]))

    def screen(self, lam_next, state: scr.DualState | None,
               rule: str = "edpp") -> torch.Tensor:
        """Discard mask bool[p] for λ_next (``engine_x_passes(rule)``
        streaming passes over X). Batched: λ_next (B,) → bool[B, p], the
        same passes for the whole batch."""
        ws = self.ws
        if ws.batch is None:
            return self._screen_rows([self._query(None, float(lam_next),
                                                  state)], rule)[0]
        lams = _host_rows(lam_next)
        return self._screen_rows([self._query(b, float(lam), state)
                                  for b, lam in enumerate(lams)], rule)

    def _matvec(self, rows: list[torch.Tensor]) -> torch.Tensor:
        """The stacked rows' dots with X in one ``screen_matvec`` call
        (one launch per MAX_B rows; one all-gather on a mesh)."""
        ws = self.ws
        return ws.backend.matvec(ws.X, torch.stack(rows))

    def _rows_of(self, values, ref: torch.Tensor) -> torch.Tensor:
        """Per-query scalars (host floats or 0-d tensors) as a (B, 1)
        column of ref's dtype and device."""
        return torch.stack([scr._like(v, ref) for v in values])[:, None]

    def _screen_rows(self, qs: list["_Query"], rule: str) -> torch.Tensor:
        """The (B, p) mask of B queries: the rule's rows stacked into its
        passes, each query's scalars from the rank-1 rules, one
        elementwise combine."""
        ws = self.ws
        B, norms = len(qs), ws.col_norms
        if rule == "none":
            self._count(0)
            return torch.zeros((B, self.p), dtype=torch.bool,
                               device=ws.X.device)
        if rule not in ENGINE_RULES:
            raise ValueError(f"unknown screening rule {rule!r}; available: "
                             f"{ENGINE_RULES}")
        base = rule[:-4] if rule.endswith("_cut") else None
        eps = [self.eps] * B
        if rule == "strong":
            # |x_iᵀ(y − Xβ*(λ₀))| < 2λ − λ₀ (basic: the λ_max state)
            dot = self._matvec([q.state.theta * q.state.lam for q in qs])
            thr = [scr.strong_threshold(q.lam, q.state.lam, self.eps)
                   for q in qs]
            mask = torch.abs(dot) < self._rows_of(thr, dot)
        elif rule == "dome":
            c = [q.y / q.lam for q in qs]
            rho = [scr._norm(q.y) * (1.0 / q.lam - 1.0 / q.lam_max)
                   for q in qs]
            scores_c = self._matvec(c)
            gdot = self._matvec([q.cut.ghat for q in qs])
            t_b = [scr.dome_t_b(cb, r, q.cut.ghat, q.cut.b)
                   for cb, r, q in zip(c, rho, qs)]
            mask = scr.cap_scores(scores_c, gdot, norms,
                                  self._rows_of(rho, gdot),
                                  self._rows_of(t_b, gdot)) \
                < self._rows_of([1.0 - e for e in eps], gdot)
            # the dome sup at x* is identically 1, on the threshold
            mask[torch.arange(B), torch.tensor([q.istar for q in qs])] = False
        else:
            # a sphere (the rule's, or a cut's base) and, for a cut, ĝ
            # stacked into the same matvec
            sphere = base or rule
            if sphere == "gap":
                # the centre θ₀/max(1, ‖Xᵀθ₀‖∞) is rescaled from the same
                # dots (never the sphere with θ₀ assumed feasible)
                rows = [q.state.theta for q in qs]
            else:
                tests = [scr.safe_sphere(q.y, q.lam, q.lam_max)
                         if rule == "safe" else
                         scr.make_sphere(sphere, q.y, q.lam, q.state)
                         for q in qs]
                rows = [t.centre for t in tests]
                if rule == "safe":
                    # eq. 15's eps is at λ scale: eps/λ once normalised
                    eps = [self.eps / q.lam for q in qs]
            dot = self._matvec(rows + ([q.cut.ghat for q in qs] if base
                                       else []))
            dot_c = dot[:B]
            if sphere == "gap":
                sup = scr.sup_corr(dot_c)
                tests = [scr.gap_sphere(q.y, q.lam, q.state, sup_corr=sup[b])
                         for b, q in enumerate(qs)]
                s = torch.clamp(sup, min=1.0)[:, None]
            rho = self._rows_of([t.rho for t in tests], dot)
            if base:
                t_b = [scr.dome_t_b(t.centre, t.rho, q.cut.ghat, q.cut.b)
                       for t, q in zip(tests, qs)]
                scores = scr.cap_scores(
                    dot_c / s if sphere == "gap" else dot_c, dot[B:], norms,
                    rho, self._rows_of(t_b, dot))
            else:
                scores = (torch.abs(dot_c) / s if sphere == "gap"
                          else torch.abs(dot_c)) + rho * norms
            mask = scores < self._rows_of([1.0 - e for e in eps], dot)
        self._count(engine_x_passes(rule))
        return mask


class _Query(NamedTuple):
    """One query of a screen: its row of y, λ and λ_max as host floats,
    its (rank-1) state, its feasibility cut and its λ_max feature."""
    y: torch.Tensor
    lam: float
    lam_max: float
    state: scr.DualState | None
    cut: scr.HalfSpaceCut
    istar: int


def _host_rows(lam) -> np.ndarray:
    """Per-query λ as a float64 host (B,) array (from a tensor, an array or
    a sequence)."""
    if isinstance(lam, torch.Tensor):
        lam = lam.detach().cpu().numpy()
    return np.asarray(lam, dtype=np.float64).reshape(-1)


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

    @property
    def p(self) -> int:
        return self.X.shape[1]

    def state_at_lambda_max(self) -> gscr.GroupDualState:
        return self._state_max

    def make_state(self, beta, lam: float, *,
                   fitted=None) -> gscr.GroupDualState:
        """The sequential state from the solution at λ, with the λ̄_max
        branch served from the cache. ``fitted`` (= Xβ, from the reduced
        bucket) skips the X·β pass."""
        if scr.at_lmax(lam, self.lam_max):
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
