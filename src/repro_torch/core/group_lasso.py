"""Group Lasso (paper eq. 50) objective and dual helpers.

    inf_β ½‖y − Σ_g X_g β_g‖² + λ Σ_g √n_g ‖β_g‖₂

Equal contiguous groups of size m (n_g = m for all g, the layout of the
paper's §4.2 experiments): groups live on the last axis as
``β.reshape(G, m)``. The dual (eq. 51) and the KKT system (eqs. 52-53)
mirror the Lasso's, with the polytope replaced by an intersection of
ellipsoids. A copy of ``repro.core.group_lasso``; the block-FISTA solver
is the ``group_fista`` strategy of :mod:`.solver`.
"""

from __future__ import annotations

import math

import torch


def group_norms(v: torch.Tensor, m: int) -> torch.Tensor:
    """‖v_g‖₂ for the contiguous groups of m entries of v."""
    return torch.linalg.vector_norm(v.reshape(-1, m), dim=1)


def group_soft_threshold(u: torch.Tensor, thresh, m: int) -> torch.Tensor:
    """Block soft-threshold: β_g = max(0, 1 − t√m/‖u_g‖)·u_g (groups of m)."""
    ug = u.reshape(-1, m)
    norms = torch.linalg.vector_norm(ug, dim=1, keepdim=True)
    scale = torch.clamp(1.0 - thresh * math.sqrt(m) / (norms + 1e-30),
                        min=0.0)
    return (scale * ug).reshape(-1)


def group_lambda_max(X: torch.Tensor, y: torch.Tensor, m: int) -> torch.Tensor:
    """λ̄_max = max_g ‖X_gᵀy‖/√n_g (eq. 55)."""
    return torch.max(group_norms(X.T @ y, m)) / math.sqrt(m)


def group_primal(X, y, beta, lam, m: int):
    r = y - X @ beta
    return 0.5 * torch.sum(r * r) \
        + lam * math.sqrt(m) * torch.sum(group_norms(beta, m))


def group_gap_from_residual(r, dot, beta, lam, m: int, y):
    """Group duality gap from r = y − Xβ and dot = Xᵀr (the two X passes
    hoisted out). The dual point is r/λ scaled into
    F̄ = {θ: ‖X_gᵀθ‖ ≤ √n_g ∀g}."""
    ratio = torch.max(group_norms(dot, m)) / math.sqrt(m)
    s = torch.clamp(lam / (ratio + 1e-30), max=1.0)
    d = s * r - y
    return (0.5 * torch.sum(r * r)
            + lam * math.sqrt(m) * torch.sum(group_norms(beta, m))
            - 0.5 * torch.sum(y * y) + 0.5 * torch.sum(d * d))


def group_duality_gap(X, y, beta, lam, m: int):
    """Gap with the dual point r/λ scaled into F̄."""
    r = y - X @ beta
    return group_gap_from_residual(r, X.T @ r, beta, lam, m, y)
