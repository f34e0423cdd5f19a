"""Group-Lasso screening: group EDPP (paper §3, Corollary 21) and the group
strong rule, for equal contiguous groups of size m.

Group EDPP is the paper's exact (safe) rule for the group Lasso: bound
θ*(λ) in a ball (Theorem 19, through the ray of Lemma 18), take the sup
of ‖X_gᵀθ‖ over the ball (Theorem 20), test against √n_g. A copy of
``repro.core.group_screening``; these plain masks are the oracle of the
group engine (:class:`~.engine.GroupScreeningEngine`), which scores
through the ``group_screen_scores`` kernel: the engine passes that kernel in as
``scores`` and otherwise runs these same functions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .group_lasso import group_norms

EPS_DEFAULT = 1e-6


class GroupDualState(NamedTuple):
    theta: torch.Tensor    # θ*(λ₀) via KKT eq. (52)
    lam: torch.Tensor      # λ₀ (0-d, the dictionary's dtype)
    v1: torch.Tensor       # v̄₁ of eq. (59)


def _group_view(X: torch.Tensor, m: int) -> torch.Tensor:
    """(N, p) → (G, N, m) group-major view of the design matrix."""
    n = X.shape[0]
    return X.reshape(n, -1, m).permute(1, 0, 2)


def group_spectral_norms(X: torch.Tensor, m: int) -> torch.Tensor:
    """Exact ‖X_g‖₂ per group: the top eigenvalue of each m × m Gram
    (``torch.linalg.eigvalsh``, batched). Theorem 20 needs the operator
    norm; the Frobenius norm would be safe but looser."""
    Xg = _group_view(X, m)                               # (G, N, m)
    grams = Xg.transpose(1, 2) @ Xg                      # (G, m, m)
    eig = torch.linalg.eigvalsh(grams)[..., -1]
    return torch.sqrt(torch.clamp(eig, min=0.0))


def _plain_scores(X: torch.Tensor, centre: torch.Tensor,
                  m: int) -> torch.Tensor:
    """‖X_gᵀc‖₂ per group, by a matmul (the kernel's plain version)."""
    return group_norms(X.T @ centre, m)


def group_state_at_lambda_max(X: torch.Tensor, y: torch.Tensor, m: int,
                              scores=_plain_scores) -> GroupDualState:
    """β* = 0, θ* = y/λ̄_max (eq. 57); v̄₁ = X*X*ᵀy (eq. 59, Lemma 18)."""
    gnorms = scores(X, y, m) / math.sqrt(m)
    gstar = int(torch.argmax(gnorms))
    lmax = gnorms[gstar]
    Xstar = X[:, gstar * m:(gstar + 1) * m]
    return GroupDualState(theta=y / lmax, lam=lmax,
                          v1=Xstar @ (Xstar.T @ y))


def group_state_from_solution(X, y, beta, lam, fitted=None) -> GroupDualState:
    """θ*(λ) = (y − Xβ*)/λ (KKT eq. 52). ``fitted`` (= Xβ) skips the X·β
    pass."""
    lam = torch.as_tensor(lam, dtype=X.dtype, device=X.device)
    theta = (y - (X @ beta if fitted is None else fitted)) / lam
    return GroupDualState(theta=theta, lam=lam, v1=y / lam - theta)


def group_v2_perp(y, lam_next, state: GroupDualState) -> torch.Tensor:
    """v̄₂⊥ of eq. (69): v̄₂ (eq. 68) without its component along v̄₁."""
    v1 = state.v1
    v2 = y / lam_next - state.theta
    denom = torch.sum(v1 * v1) + 1e-30
    return v2 - (torch.dot(v1, v2) / denom) * v1


def group_edpp_mask(X, y, lam_next, state: GroupDualState, m: int,
                    spec_norms: torch.Tensor | None = None,
                    eps: float = EPS_DEFAULT, scores=_plain_scores):
    """Group EDPP (Corollary 21): discard group g iff

        ‖X_gᵀ(θ*(λ₀) + ½v̄₂⊥)‖₂ < √n_g − ½‖v̄₂⊥‖₂·‖X_g‖₂.

    Returns bool[G]. ``spec_norms`` may be computed once per dictionary;
    ``scores(X, c, m)`` computes ‖X_gᵀc‖₂."""
    vp = group_v2_perp(y, lam_next, state)
    centre = state.theta + 0.5 * vp
    rho = 0.5 * torch.linalg.vector_norm(vp)
    if spec_norms is None:
        spec_norms = group_spectral_norms(X, m)
    return scores(X, centre, m) < math.sqrt(m) - rho * spec_norms - eps


def group_strong_mask(X, y, lam_next, state: GroupDualState, m: int,
                      eps: float = EPS_DEFAULT, scores=_plain_scores):
    """Group strong rule (Tibshirani et al. 2012), heuristic: discard g
    iff ‖X_gᵀ(y − Xβ*(λ₀))‖ < √n_g(2λ − λ₀). Needs the KKT check."""
    return (scores(X, state.theta * state.lam, m)
            < math.sqrt(m) * (2.0 * lam_next - state.lam) - eps)


def group_kkt_violations(X, y, beta, lam, discarded_groups, m: int,
                         tol: float = 1e-4, fitted=None):
    """Discarded groups violating ‖X_gᵀr‖ ≤ λ√n_g (KKT eq. 53).
    ``fitted`` (= Xβ) skips the X·β pass."""
    r = y - (X @ beta if fitted is None else fitted)
    scores = group_norms(X.T @ r, m)
    return (scores > lam * math.sqrt(m) * (1.0 + tol)) & discarded_groups


GROUP_RULES = {
    "edpp": group_edpp_mask,
    "strong": group_strong_mask,
}
