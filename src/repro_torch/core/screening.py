"""Safe (and heuristic) screening rules for the Lasso.

Every ball rule is the same test with a different ball: for a sphere
B(centre, ρ) that provably contains θ*(λ),

    discard i  ⟺  |x_iᵀ·centre| + ρ‖x_i‖ < 1 − eps.

This module holds the paper's sequential rules as explicit
:class:`SphereTest` constructors — DPP (Theorem 3), Improvement 1
(Theorem 11), Improvement 2 (Theorem 14), EDPP (Theorem 16 /
Corollary 17), sequential SAFE, basic SAFE and the GAP-safe sphere
(Fercoq, Gramfort & Salmon 2015) — with their plain mask functions, the
:class:`DualState` they thread along the λ-path, and the KKT violation
check; and the rules that are not one ball:

* the strong rule (Tibshirani et al. 2012), heuristic: the path backs it
  with the KKT loop;
* DOME (Xiang et al.), basic only: the exact sup over the SAFE ball cut
  by the λ_max feature's half-space;
* ``<base>_cut`` for every sequential sphere: the base ball intersected
  with the λ_max feasibility cut {θ : ĝᵀθ ≤ 1/‖g‖}
  (:class:`HalfSpaceCut`), the same closed form as DOME's.

The engine (:mod:`.engine`) evaluates the same tests through the
screening kernel; these masks are its oracle, their dots summed as the
kernels' plain version sums them. Column norms are ``sqrt(Σ x_ij²)``,
the sum the fit's fused pass caches. :func:`dome_score_bounds` bounds
the cap sup over intervals of its inputs, for the bf16 screen's
per-piece margins.

Query operands may carry a leading batch axis B (y/θ/v₁ (B, n), λ/ρ
(B,)); rank-1 inputs take the single-query arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.ref import column_dots

EPS_DEFAULT = 1e-6


class DualState(NamedTuple):
    """What the sequential rules need about the previous grid point.

    theta:    θ*(λ₀) = (y − Xβ*(λ₀))/λ₀
    lam:      λ₀
    v1:       the ray direction of Theorem 7 / eq. (17)
    at_lmax:  whether λ₀ == λ_max (selects the v₁ branch of eq. 17)
    beta_l1:  ‖β*(λ₀)‖₁
    """

    theta: torch.Tensor
    lam: torch.Tensor | float | np.ndarray
    v1: torch.Tensor
    at_lmax: bool | torch.Tensor | np.ndarray
    beta_l1: torch.Tensor | float = 0.0

    def query(self, b: int) -> "DualState":
        """Query b of a batched state (θ, v₁ (B, n); λ, at_lmax host (B,)
        arrays) as the single-query state the rank-1 rules take: λ a host
        float, θ and v₁ fresh copies of their rows, so its sphere rounds
        as a single query's does."""
        return DualState(theta=self.theta[b].clone(), lam=float(self.lam[b]),
                         v1=self.v1[b].clone(),
                         at_lmax=bool(self.at_lmax[b]),
                         beta_l1=self.beta_l1[b])

    @staticmethod
    def at_lambda_max(X: torch.Tensor, y: torch.Tensor) -> "DualState":
        """State at λ₀ = λ_max, where β* = 0 and θ* = y/λ_max (eq. 9)."""
        corr = X.T @ y
        istar = torch.argmax(torch.abs(corr))
        lmax = torch.abs(corr)[istar]
        v1 = torch.sign(corr[istar]) * X[:, istar]
        return DualState(theta=y / lmax, lam=lmax, v1=v1, at_lmax=True,
                         beta_l1=torch.zeros((), dtype=X.dtype,
                                             device=X.device))

    @staticmethod
    def from_solution(X, y, beta, lam, lam_max=None) -> "DualState":
        """State from the primal solution β*(λ₀) via KKT eq. (3)."""
        lam = torch.as_tensor(lam, dtype=X.dtype, device=X.device)
        theta = (y - X @ beta) / lam
        at_lmax = False if lam_max is None else bool(lam >= lam_max)
        return DualState(theta=theta, lam=lam, v1=y / lam - theta,
                         at_lmax=at_lmax, beta_l1=torch.sum(torch.abs(beta)))


def at_lmax(lam: float, lmax: float) -> bool:
    """λ ≥ λ_max·(1 − 1e-12), compared in float32 as the reference's
    jitted state builder does: whether the sequential state at λ is the
    λ_max one."""
    return bool(np.float32(lam) >= np.float32(lmax) * np.float32(1.0 - 1e-12))


def at_lmax_rows(lam, lmax) -> np.ndarray:
    """:func:`at_lmax` per query: λ_b ≥ λ_max,b·(1 − 1e-12) in float32,
    as the reference's batched state builder compares (B,) rows."""
    return (np.asarray(lam, np.float32)
            >= np.asarray(lmax, np.float32) * np.float32(1.0 - 1e-12))


def lambda_max(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """λ_max = max_i |x_iᵀy| (eq. 7): the smallest λ with β*(λ) = 0."""
    return torch.max(torch.abs(X.T @ y))


def make_dual_state(X, y, beta, lam, lam_max_val) -> DualState:
    """The sequential state, branch-correct at λ₀ == λ_max."""
    if lam >= lam_max_val * (1.0 - 1e-12):
        return DualState.at_lambda_max(X, y)
    return DualState.from_solution(X, y, beta, lam)


def _is_batched(y) -> bool:
    return y.dim() == 2


def _col(s) -> torch.Tensor:
    """(B,) → (B, 1) for broadcasting against (B, n)."""
    return torch.as_tensor(s)[..., None]


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


def v2_perp(y, lam_next, state: DualState) -> torch.Tensor:
    """v₂⊥(λ, λ₀) of eq. (19): v₂ with its component along v₁ removed."""
    v1 = state.v1
    if _is_batched(y):
        v2 = y / _col(lam_next) - state.theta                 # eq. (18)
        denom = torch.sum(v1 * v1, dim=-1) + 1e-30
        return v2 - _col(torch.sum(v1 * v2, dim=-1) / denom) * v1
    v2 = y / lam_next - state.theta
    denom = torch.sum(v1 * v1) + 1e-30
    return v2 - (torch.dot(v1, v2) / denom) * v1


class SphereTest(NamedTuple):
    """A safe sphere B(centre, rho) ∋ θ*(λ): discard i iff
    |x_iᵀ·centre| + rho·‖x_i‖ < 1 (up to eps). Batched: centre (B, n),
    rho (B,)."""

    centre: torch.Tensor
    rho: torch.Tensor


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    """A host number or tensor as a tensor of ref's dtype and device."""
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def dpp_sphere(y, lam_next, state: DualState) -> SphereTest:
    """DPP (Theorem 3): B(θ*(λ₀), |1/λ − 1/λ₀|·‖y‖)."""
    rho = torch.abs(_like(1.0 / lam_next - 1.0 / state.lam, y)) * _norm(y)
    return SphereTest(centre=state.theta, rho=rho)


def imp1_sphere(y, lam_next, state: DualState) -> SphereTest:
    """Improvement 1 (Theorem 11): B(θ*(λ₀), ‖v₂⊥‖)."""
    return SphereTest(centre=state.theta,
                      rho=_norm(v2_perp(y, lam_next, state)))


def imp2_sphere(y, lam_next, state: DualState) -> SphereTest:
    """Improvement 2 (Theorem 14): half-radius ball at a shifted centre."""
    d = _like(0.5 * (1.0 / lam_next - 1.0 / state.lam), y)
    if _is_batched(y):
        return SphereTest(centre=state.theta + _col(d) * y,
                          rho=torch.abs(d) * _norm(y))
    return SphereTest(centre=state.theta + d * y, rho=torch.abs(d) * _norm(y))


def edpp_sphere(y, lam_next, state: DualState) -> SphereTest:
    """EDPP (Theorem 16 / Corollary 17): B(θ*(λ₀) + ½v₂⊥, ½‖v₂⊥‖)."""
    vp = v2_perp(y, lam_next, state)
    return SphereTest(centre=state.theta + 0.5 * vp, rho=0.5 * _norm(vp))


def seq_safe_sphere(y, lam_next, state: DualState) -> SphereTest:
    """Sequential SAFE: B(y/λ, ‖y/λ − θ*(λ₀)‖)."""
    centre = y / _col(lam_next) if _is_batched(y) else y / lam_next
    return SphereTest(centre=centre, rho=_norm(centre - state.theta))


def safe_sphere(y, lam_next, lam_max_val) -> SphereTest:
    """Basic SAFE / ST1 (eq. 15) as the unit sphere test
    B(y/λ, ‖y‖(λ_max − λ)/(λ_max·λ))."""
    rho = _norm(y) * (lam_max_val - lam_next) / (lam_max_val * lam_next)
    centre = y / _col(lam_next) if _is_batched(y) else y / lam_next
    return SphereTest(centre=centre, rho=rho)


def gap_sphere(y, lam_next, state: DualState, sup_corr=None) -> SphereTest:
    """GAP-safe sphere (Fercoq, Gramfort & Salmon 2015, Theorem 2):
    B(θ_c, √(2·G_λ(β₀, θ_c))/λ) with G the duality gap at λ of the previous
    grid point's pair, so it stays safe when β₀ is an inexact solve.

    ``sup_corr`` = ‖Xᵀθ₀‖∞ rescales θ₀ into the feasible polytope,
    θ_c = θ₀/max(1, sup_corr); the engine takes it from the screen's own
    matvec. None trusts θ₀ to be feasible."""
    if _is_batched(y):
        s = (torch.ones(y.shape[:1], dtype=y.dtype, device=y.device)
             if sup_corr is None else torch.clamp(sup_corr, min=1.0))
        centre = state.theta / _col(s)
        resid = state.theta * _col(_like(state.lam, y))   # y − Xβ*(λ₀)
        lam_t = _like(lam_next, y)
        primal = 0.5 * torch.sum(resid * resid, dim=-1) \
            + lam_t * state.beta_l1
        dual = 0.5 * torch.sum(y * y, dim=-1) - 0.5 * lam_t * lam_t \
            * torch.sum(torch.square(centre - y / _col(lam_t)), dim=-1)
        gap = torch.clamp(primal - dual, min=0.0)
        return SphereTest(centre=centre, rho=torch.sqrt(2.0 * gap) / lam_t)
    s = 1.0 if sup_corr is None else torch.clamp(sup_corr, min=1.0)
    centre = state.theta / s
    resid = state.theta * state.lam                       # y − Xβ*(λ₀)
    primal = 0.5 * torch.sum(resid * resid) + lam_next * state.beta_l1
    dual = 0.5 * torch.sum(y * y) - 0.5 * lam_next * lam_next * torch.sum(
        torch.square(centre - y / lam_next))
    gap = torch.clamp(primal - dual, min=0.0)
    return SphereTest(centre=centre, rho=torch.sqrt(2.0 * gap) / lam_next)


SPHERE_RULES = {
    "dpp": dpp_sphere,
    "imp1": imp1_sphere,
    "imp2": imp2_sphere,
    "edpp": edpp_sphere,
    "seq_safe": seq_safe_sphere,
    "gap": gap_sphere,
}


def make_sphere(rule: str, y, lam_next, state: DualState) -> SphereTest:
    """The sphere of a sequential rule; ``gap``'s without its feasibility
    rescale (the engine and :func:`gap_mask` supply ``sup_corr``)."""
    return SPHERE_RULES[rule](y, lam_next, state)


def col_norms(X: torch.Tensor) -> torch.Tensor:
    """‖x_j‖ as the fit's fused pass computes it: sqrt(Σ_i x_ij²)."""
    return torch.sqrt(torch.sum(X * X, dim=0))


def sphere_mask(X, test: SphereTest, eps: float = EPS_DEFAULT):
    """Plain mask for a SphereTest: |x_iᵀc| + ρ‖x_i‖ < 1 − eps."""
    norms = col_norms(X)
    if _is_batched(test.centre):
        scores = torch.abs(_dots(X, test.centre)) + _col(test.rho) * norms
        return scores < 1.0 - _col(torch.as_tensor(eps))
    scores = torch.abs(_dots(X, test.centre)) + test.rho * norms
    return scores < 1.0 - eps


def dpp_mask(X, y, lam_next, state: DualState, eps: float = EPS_DEFAULT):
    return sphere_mask(X, dpp_sphere(y, lam_next, state), eps)


def imp1_mask(X, y, lam_next, state: DualState, eps: float = EPS_DEFAULT):
    return sphere_mask(X, imp1_sphere(y, lam_next, state), eps)


def imp2_mask(X, y, lam_next, state: DualState, eps: float = EPS_DEFAULT):
    return sphere_mask(X, imp2_sphere(y, lam_next, state), eps)


def edpp_mask(X, y, lam_next, state: DualState, eps: float = EPS_DEFAULT):
    """EDPP: discard i iff |x_iᵀ(θ*(λ₀) + ½v₂⊥)| < 1 − ½‖v₂⊥‖·‖x_i‖."""
    return sphere_mask(X, edpp_sphere(y, lam_next, state), eps)


def seq_safe_mask(X, y, lam_next, state: DualState, eps: float = EPS_DEFAULT):
    return sphere_mask(X, seq_safe_sphere(y, lam_next, state), eps)


def safe_mask(X, y, lam_next, lam_max_val, eps: float = EPS_DEFAULT):
    """Basic SAFE (eq. 15); its eps lives at λ scale, so eps/λ here."""
    return sphere_mask(X, safe_sphere(y, lam_next, lam_max_val),
                       eps / lam_next)


def _dots(X, v) -> torch.Tensor:
    """Xᵀv (p,) for v (n,), vX (B, p) for v (B, n), row by row in the
    screening kernels' plain arithmetic (:func:`~repro_torch.kernels.ref.
    column_dots`), so the engine's CPU screens equal these oracles bit for
    bit."""
    if _is_batched(v):
        return torch.stack([column_dots(X, row) for row in v])
    return column_dots(X, v)


def sup_corr(dot: torch.Tensor) -> torch.Tensor:
    """‖Xᵀθ₀‖∞ from the screen's dots: () or (B,)."""
    return torch.amax(torch.abs(dot), dim=-1)


def gap_scores(dot, test: SphereTest, sup, norms) -> torch.Tensor:
    """GAP's sphere scores from the dots Xᵀθ₀ that also gave ``sup``:
    |x_jᵀθ₀|/max(1, sup) + ρ‖x_j‖."""
    s = torch.clamp(sup, min=1.0)
    if dot.dim() == 2:
        return torch.abs(dot) / _col(s) + _col(test.rho) * norms
    return torch.abs(dot) / s + test.rho * norms


def gap_mask(X, y, lam_next, state: DualState, eps: float = EPS_DEFAULT):
    """GAP-safe sphere rule: one matvec Xᵀθ₀ serves the feasibility
    rescale ‖Xᵀθ₀‖∞ and the scores."""
    dot = _dots(X, state.theta)
    sup = sup_corr(dot)
    test = gap_sphere(y, lam_next, state, sup_corr=sup)
    return gap_scores(dot, test, sup, col_norms(X)) < 1.0 - eps


def strong_threshold(lam_next, lam_prev, eps: float = EPS_DEFAULT):
    """The strong rule's bound 2λ − λ₀ − eps."""
    return 2.0 * lam_next - lam_prev - eps


def strong_mask(X, y, lam_next, state: DualState, eps: float = EPS_DEFAULT):
    """Sequential strong rule (Tibshirani et al. 2012), *heuristic*:
    discard i iff |x_iᵀ(y − Xβ*(λ₀))| < 2λ − λ₀. It may discard active
    features, so the path runs the KKT loop after it. Basic variant: the
    state at λ_max gives |x_iᵀy| < 2λ − λ_max."""
    if _is_batched(y):
        lam_prev = _like(state.lam, y)
        resid_corr = torch.abs(_dots(X, state.theta * _col(lam_prev)))
        return resid_corr < _col(strong_threshold(_like(lam_next, y),
                                                  lam_prev, eps))
    resid_corr = torch.abs(_dots(X, state.theta * state.lam))
    return resid_corr < strong_threshold(lam_next, state.lam, eps)


def dome_t_b(c, rho, ghat, b):
    """The clipped cap threshold t_b = clip((b − ĝᵀc)/ρ, −1, 1) of the
    ball B(c, ρ) cut by {ĝᵀθ ≤ b}."""
    if _is_batched(c):
        return torch.clamp((b - torch.sum(ghat * c, dim=-1))
                           / (rho + 1e-30), -1.0, 1.0)
    return torch.clamp((b - torch.dot(ghat, c)) / (rho + 1e-30), -1.0, 1.0)


def _sup_over_cap(a_scores, a_gdot, a_norms, rho, t_b):
    """sup aᵀθ over B(c, ρ) ∩ {ĝᵀθ ≤ b} from a_scores = aᵀc, a_gdot = aᵀĝ,
    a_norms = ‖a‖ and the cap threshold ``t_b`` (:func:`dome_t_b`):
    decompose a along ĝ; the cut clips the sphere maximiser at t_b.
    ``rho`` and ``t_b`` are () for a (p,) row, (B, 1) for (B, p) rows."""
    t_star = a_gdot / (a_norms + 1e-30)           # unconstrained maximiser
    a_perp = torch.sqrt(torch.clamp(a_norms * a_norms - a_gdot * a_gdot,
                                    min=0.0))
    unclipped = a_scores + rho * a_norms
    clipped = a_scores + rho * (
        a_gdot * t_b
        + a_perp * torch.sqrt(torch.clamp(1.0 - t_b * t_b, min=0.0)))
    return torch.where(t_star <= t_b, unclipped, clipped)


def cap_scores(scores_c, gdot, norms, rho, t_b):
    """max(sup ±x_jᵀθ) over the ball ∩ half-space, elementwise in the two
    dots (the engine's combine; ``rho``/``t_b`` as in
    :func:`_sup_over_cap`)."""
    return torch.maximum(_sup_over_cap(scores_c, gdot, norms, rho, t_b),
                         _sup_over_cap(-scores_c, -gdot, norms, rho, t_b))


def _sup_over_dome(a_scores, a_gdot, a_norms, c, rho, ghat, b):
    """sup_{θ ∈ B(c,ρ) ∩ {ĝᵀθ ≤ b}} aᵀθ for a batch of directions a."""
    t_b = dome_t_b(c, rho, ghat, b)
    if _is_batched(c):
        return _sup_over_cap(a_scores, a_gdot, a_norms, _col(rho), _col(t_b))
    return _sup_over_cap(a_scores, a_gdot, a_norms, rho, t_b)


def dome_scores(scores_c, gdot, norms, c, rho, ghat, b):
    """max(sup ±x_iᵀθ) over the dome, from the two matvecs."""
    return torch.maximum(
        _sup_over_dome(scores_c, gdot, norms, c, rho, ghat, b),
        _sup_over_dome(-scores_c, -gdot, norms, c, rho, ghat, b))


def _cap_sup(g, t_b, a_norms):
    """h(g, t_b): the unit-ρ cap term of :func:`_sup_over_cap` as a
    function of one dot g = aᵀĝ,

        h = ‖a‖                                 if g/‖a‖ ≤ t_b (unclipped)
            g·t_b + √(‖a‖²−g²)₊·√(1−t_b²)₊       otherwise   (clipped)

    for the interval bounds below (the exact combines keep
    :func:`_sup_over_cap`)."""
    perp = torch.sqrt(torch.clamp(a_norms * a_norms - g * g, min=0.0))
    clipped = g * t_b + perp * torch.sqrt(
        torch.clamp(1.0 - t_b * t_b, min=0.0))
    return torch.where(g <= t_b * (a_norms + 1e-30), a_norms, clipped)


def dome_sup_bounds(s_lo, s_hi, g_lo, g_hi, a_norms, rho_lo, rho_hi,
                    tb_lo, tb_hi):
    """Interval bound on the cap sup s + ρ·h(g, t_b) given intervals on
    its inputs: s ∈ [s_lo, s_hi], g ∈ [g_lo, g_hi], ρ ∈ [rho_lo, rho_hi]
    (ρ ≥ 0), t_b ∈ [tb_lo, tb_hi]; ρ and t_b are () or (B,) for (p,) or
    (B, p) dots. Returns (lo, hi) with the exact sup inside.

    h is piecewise in g (constant ‖a‖ while unclipped, concave decreasing
    on the cap up to g = ‖a‖, then linear g·t_b), so its max over
    [g_lo, g_hi] lies at an endpoint and its min may need the breakpoint
    g = ‖a‖ as a third candidate; h is non-decreasing in t_b, so hi takes
    tb_hi and lo tb_lo."""
    if s_lo.dim() == 2:
        rho_lo, rho_hi = _col(rho_lo), _col(rho_hi)
        tb_lo, tb_hi = _col(tb_lo), _col(tb_hi)
    g_brk = torch.minimum(torch.maximum(a_norms, g_lo), g_hi)
    h_hi = torch.maximum(_cap_sup(g_lo, tb_hi, a_norms),
                         _cap_sup(g_hi, tb_hi, a_norms))
    h_lo = torch.minimum(
        torch.minimum(_cap_sup(g_lo, tb_lo, a_norms),
                      _cap_sup(g_hi, tb_lo, a_norms)),
        _cap_sup(g_brk, tb_lo, a_norms))
    # ρ ≥ 0 but h may be negative: take both corners of ρ·h
    hi = s_hi + torch.maximum(rho_lo * h_hi, rho_hi * h_hi)
    lo = s_lo + torch.minimum(rho_lo * h_lo, rho_hi * h_lo)
    return lo, hi


def dome_score_bounds(s_lo, s_hi, g_lo, g_hi, a_norms, rho_lo, rho_hi,
                      tb_lo, tb_hi):
    """Interval bound on :func:`cap_scores` = max(sup over ±x_j): the +
    branch takes (s, g), the − branch (−s, −g) with the endpoints swapped
    and negated. The exact max lies in [lo, hi]."""
    lo_p, hi_p = dome_sup_bounds(s_lo, s_hi, g_lo, g_hi, a_norms,
                                 rho_lo, rho_hi, tb_lo, tb_hi)
    lo_n, hi_n = dome_sup_bounds(-s_hi, -s_lo, -g_hi, -g_lo, a_norms,
                                 rho_lo, rho_hi, tb_lo, tb_hi)
    return torch.maximum(lo_p, lo_n), torch.maximum(hi_p, hi_n)


def _lmax_ray(X, y):
    """(g, istar): the λ_max feature's ray g = sign(x*ᵀy)·x* and x*'s
    index, () or (B,)."""
    corr = _dots(X, y)
    istar = torch.argmax(torch.abs(corr), dim=-1)
    if _is_batched(y):
        sgn = torch.sign(corr.gather(1, istar[:, None])[:, 0])
        return _col(sgn) * X[:, istar].T, istar
    return torch.sign(corr[istar]) * X[:, istar], istar


def dome_mask(X, y, lam_next, lam_max_val, eps: float = EPS_DEFAULT):
    """DOME (Xiang et al.), basic rule only (paper §4.1): the exact sup
    of ±x_iᵀθ over B(y/λ, ‖y‖(1/λ − 1/λ_max)) ∩ {ĝᵀθ ≤ 1/‖g‖}, with
    g = sign(x*ᵀy)·x* the λ_max feature's ray. Both sets contain θ*(λ).

    The sup at x* itself is identically 1 (θ = y/λ_max lies on both
    boundaries with x*ᵀθ = 1), exactly on the threshold, so rounding
    could evict the λ_max feature: it is pinned kept. Batched: y (B, n),
    λ and λ_max (B,) → (B, p), each query its own x*."""
    g, istar = _lmax_ray(X, y)
    cut = cut_from_ray(g)
    norms = col_norms(X)
    if _is_batched(y):
        lam_t, lmax_t = _like(lam_next, y), _like(lam_max_val, y)
        c = y / _col(lam_t)
        rho = _norm(y) * (1.0 / lam_t - 1.0 / lmax_t)
    else:
        c = y / lam_next
        rho = _norm(y) * (1.0 / lam_next - 1.0 / lam_max_val)
    dec = dome_scores(_dots(X, c), _dots(X, cut.ghat), norms, c, rho,
                      cut.ghat, cut.b) < 1.0 - eps
    if _is_batched(y):
        return dec & (torch.arange(X.shape[1], device=X.device)[None, :]
                      != istar[:, None])
    dec[istar] = False
    return dec


class HalfSpaceCut(NamedTuple):
    """A dual cutting half-space {θ : ĝᵀθ ≤ b}, composable with any
    :class:`SphereTest`: the sup of ±x_jᵀθ over ball ∩ half-space has
    DOME's closed form and needs one more dot per column (Xᵀĝ), which the
    engine stacks into the sphere centre's matvec. A cut that misses the
    ball clips t_b to 1 and gives the sphere's own sup.

    ghat: unit normal, (n,) or (B, n);  b: offset, () or (B,)."""

    ghat: torch.Tensor
    b: torch.Tensor


def cut_from_ray(v1) -> HalfSpaceCut:
    """The λ_max feasibility cut from the ray g = sign(x*ᵀy)·x*: every
    θ ∈ F has gᵀθ ≤ 1, i.e. ĝᵀθ ≤ 1/‖g‖. Batched: v1 (B, n)."""
    gnorm = _norm(v1) + 1e-30
    if _is_batched(v1):
        return HalfSpaceCut(ghat=v1 / _col(gnorm), b=1.0 / gnorm)
    return HalfSpaceCut(ghat=v1 / gnorm, b=1.0 / gnorm)


def feasibility_cut(X, y) -> HalfSpaceCut:
    """The λ_max feasibility cut computed from scratch (Xᵀy, x*)."""
    return cut_from_ray(_lmax_ray(X, y)[0])


def halfspace_sup(scores_c, gdot, norms, test: SphereTest,
                  cut: HalfSpaceCut):
    """sup |x_jᵀθ| over B(centre, ρ) ∩ {ĝᵀθ ≤ b} from scores_c = Xᵀ·centre
    and gdot = Xᵀĝ. A cut whose half-space holds the whole ball gives the
    sphere sup |scores_c| + ρ‖x_j‖ bit for bit."""
    return dome_scores(scores_c, gdot, norms, test.centre, test.rho,
                       cut.ghat, cut.b)


def cut_mask(X, test: SphereTest, cut: HalfSpaceCut,
             eps: float = EPS_DEFAULT):
    """Plain mask for sphere ∩ half-space: discard j iff the sup of
    |x_jᵀθ| over the intersection is < 1 − eps; a superset of
    ``sphere_mask(X, test, eps)``'s discards."""
    return halfspace_sup(_dots(X, test.centre), _dots(X, cut.ghat),
                         col_norms(X), test, cut) < 1.0 - eps


def _make_cut_rule(base: str):
    """The mask of ``<base>_cut``: the base rule's sphere intersected with
    the λ_max feasibility cut. Signature as :data:`RULES`."""
    def mask(X, y, lam_next, state: DualState, eps: float = EPS_DEFAULT):
        cut = feasibility_cut(X, y)
        norms = col_norms(X)
        if base == "gap":
            # as gap_mask: one dot gives the rescale and the centre scores
            dot = _dots(X, state.theta)
            sup = sup_corr(dot)
            test = gap_sphere(y, lam_next, state, sup_corr=sup)
            s = torch.clamp(sup, min=1.0)
            scores_c = dot / (_col(s) if dot.dim() == 2 else s)
        else:
            test = SPHERE_RULES[base](y, lam_next, state)
            scores_c = _dots(X, test.centre)
        return halfspace_sup(scores_c, _dots(X, cut.ghat), norms, test,
                             cut) < 1.0 - eps

    mask.__name__ = f"{base}_cut_mask"
    mask.__doc__ = (f"The {base!r} sphere ∩ the λ_max feasibility cut "
                    f"{{θ : ĝᵀθ ≤ 1/‖g‖}}: safe, and discards ⊇ the "
                    f"{base!r} rule's.")
    return mask


#: ``<base>_cut`` for every sequential sphere rule.
CUT_RULES = {f"{base}_cut": _make_cut_rule(base) for base in SPHERE_RULES}

gap_cut_mask = CUT_RULES["gap_cut"]
edpp_cut_mask = CUT_RULES["edpp_cut"]


def kkt_violations(X, y, beta, lam, discarded, tol: float = 1e-4,
                   fitted=None):
    """Discarded features whose KKT condition |x_iᵀr| ≤ λ(1 + tol) fails.
    ``fitted`` (= Xβ) skips the X·β pass."""
    if _is_batched(y):
        r = y - (beta @ X.T if fitted is None else fitted)
        viol = torch.abs(r @ X) > _col(lam) * (1.0 + tol)
        return viol & discarded
    r = y - (X @ beta if fitted is None else fitted)
    return (torch.abs(X.T @ r) > lam * (1.0 + tol)) & discarded


RULES = {
    "dpp": dpp_mask,
    "imp1": imp1_mask,
    "imp2": imp2_mask,
    "edpp": edpp_mask,
    "seq_safe": seq_safe_mask,
    "gap": gap_mask,
    "strong": strong_mask,
    **CUT_RULES,
}

SAFE_RULES = ("dpp", "imp1", "imp2", "edpp", "seq_safe", "gap", "safe",
              "dome", "none", *CUT_RULES)
HEURISTIC_RULES = ("strong",)


def screen(X, y, lam_next, state: DualState, rule: str = "edpp",
           eps: float = EPS_DEFAULT):
    """Dispatch over the sequential rules' plain masks."""
    return RULES[rule](X, y, lam_next, state, eps)
