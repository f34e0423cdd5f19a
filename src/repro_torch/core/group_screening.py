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
    norm; the Frobenius norm would be safe but looser.

    Each group's norm has the same bits whatever the other groups of the
    batch (a mesh rank's block of them gives the whole X's): the batched
    Gram product and eigensolver treat each group on its own, except
    that a batch of one takes another eigensolver on the card (cuSOLVER's
    ``syevd``, not the batched Jacobi: 16 of 40 norms differed in the last
    bits on an H100), so a single group is solved beside a copy of
    itself."""
    Xg = _group_view(X, m)                               # (G, N, m)
    single = Xg.shape[0] == 1
    if single:
        Xg = torch.cat([Xg, Xg])
    grams = Xg.transpose(1, 2) @ Xg                      # (G, m, m)
    eig = torch.linalg.eigvalsh(grams)[..., -1]
    if single:
        eig = eig[:1]
    return torch.sqrt(torch.clamp(eig, min=0.0))


def _plain_scores(X: torch.Tensor, centre: torch.Tensor,
                  m: int) -> torch.Tensor:
    """‖X_gᵀc‖₂ per group, by a matmul (the kernel's plain version)."""
    return group_norms(X.T @ centre, m)


def group_state_at_lambda_max(X: torch.Tensor, y: torch.Tensor, m: int,
                              scores=_plain_scores,
                              columns=None) -> GroupDualState:
    """β* = 0, θ* = y/λ̄_max (eq. 57); v̄₁ = X*X*ᵀy (eq. 59, Lemma 18).
    ``columns(cols)`` returns the global columns ``cols`` of X (a mesh
    geometry's gather; by default sliced from X)."""
    gnorms = scores(X, y, m) / math.sqrt(m)
    gstar = int(torch.argmax(gnorms))
    lmax = gnorms[gstar]
    if columns is None:
        Xstar = X[:, gstar * m:(gstar + 1) * m]
    else:
        Xstar = columns(range(gstar * m, (gstar + 1) * m))
    return GroupDualState(theta=y / lmax, lam=lmax,
                          v1=Xstar @ (Xstar.T @ y))


def group_state_from_solution(X, y, beta, lam, fitted=None) -> GroupDualState:
    """θ*(λ) = (y − Xβ*)/λ (KKT eq. 52). ``fitted`` (= Xβ) skips the X·β
    pass."""
    lam = torch.as_tensor(lam, dtype=X.dtype, device=X.device)
    theta = (y - (X @ beta if fitted is None else fitted)) / lam
    return GroupDualState(theta=theta, lam=lam, v1=y / lam - theta)


def make_group_dual_state(X, y, beta, lam, lam_max_val,
                          m: int) -> GroupDualState:
    """The sequential state at λ: the λ̄_max state where λ ≥ λ̄_max (to
    1e-12 relative), else the state from the solution β at λ."""
    if float(lam) >= float(lam_max_val) * (1.0 - 1e-12):
        return group_state_at_lambda_max(X, y, m)
    return group_state_from_solution(X, y, beta, lam)


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
                         tol: float = 1e-4, fitted=None, correlations=None):
    """Discarded groups violating ‖X_gᵀr‖ ≤ λ√n_g (KKT eq. 53).
    ``fitted`` (= Xβ) skips the X·β pass; ``correlations(r)`` returns
    Xᵀr (a geometry's, gathered on a mesh; by default ``X.T @ r``)."""
    r = y - (X @ beta if fitted is None else fitted)
    dots = X.T @ r if correlations is None else correlations(r)
    scores = group_norms(dots, m)
    return (scores > lam * math.sqrt(m) * (1.0 + tol)) & discarded_groups


GROUP_RULES = {
    "edpp": group_edpp_mask,
    "strong": group_strong_mask,
}


def group_screen(X, y, lam_next, state: GroupDualState, m: int,
                 rule: str = "edpp", spec_norms=None,
                 eps: float = EPS_DEFAULT):
    """The discard mask bool[G] of a group rule: ``"edpp"``, else the
    group strong rule (the reference's dispatch)."""
    if rule == "edpp":
        return group_edpp_mask(X, y, lam_next, state, m, spec_norms, eps)
    return group_strong_mask(X, y, lam_next, state, m, eps)
