"""Safe sphere screening rules for the Lasso (main subset of the port).

Every ball rule is the same test with a different ball: for a sphere
B(centre, ρ) that provably contains θ*(λ),

    discard i  ⟺  |x_iᵀ·centre| + ρ‖x_i‖ < 1 − eps.

This module holds the paper's sequential rules as explicit
:class:`SphereTest` constructors — DPP (Theorem 3), Improvement 1
(Theorem 11), Improvement 2 (Theorem 14), EDPP (Theorem 16 /
Corollary 17), sequential SAFE and basic SAFE — with their plain mask
functions, the :class:`DualState` they thread along the λ-path, and the
KKT violation check. The engine (:mod:`.engine`) evaluates the same tests
through the screening kernel; these masks are its oracle.

Query operands may carry a leading batch axis B (y/θ/v₁ (B, n), λ/ρ
(B,)); rank-1 inputs take the single-query arithmetic.

The GAP, DOME, strong and half-space-cut rules are not ported yet
(ROADMAP.md, queue 1 item 8).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
    lam: torch.Tensor | float
    v1: torch.Tensor
    at_lmax: bool | torch.Tensor
    beta_l1: torch.Tensor | float = 0.0

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


SPHERE_RULES = {
    "dpp": dpp_sphere,
    "imp1": imp1_sphere,
    "imp2": imp2_sphere,
    "edpp": edpp_sphere,
    "seq_safe": seq_safe_sphere,
}


def make_sphere(rule: str, y, lam_next, state: DualState) -> SphereTest:
    return SPHERE_RULES[rule](y, lam_next, state)


def sphere_mask(X, test: SphereTest, eps: float = EPS_DEFAULT):
    """Plain mask for a SphereTest: |x_iᵀc| + ρ‖x_i‖ < 1 − eps."""
    col_norms = torch.linalg.vector_norm(X, dim=0)
    if _is_batched(test.centre):
        scores = torch.abs(test.centre @ X) + _col(test.rho) * col_norms
        return scores < 1.0 - _col(torch.as_tensor(eps))
    scores = torch.abs(X.T @ test.centre) + test.rho * col_norms
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
}


def screen(X, y, lam_next, state: DualState, rule: str = "edpp",
           eps: float = EPS_DEFAULT):
    """Dispatch over the sequential rules' plain masks."""
    return RULES[rule](X, y, lam_next, state, eps)
