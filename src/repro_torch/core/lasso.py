"""Lasso objective and dual geometry shared by the solvers.

Primal:  P(β) = ½‖y − Xβ‖² + λ‖β‖₁
Dual:    D(θ) = ½‖y‖² − λ²/2‖θ − y/λ‖²  s.t. |x_iᵀθ| ≤ 1
The duality gap is the stopping criterion; a feasible dual point comes
from scaling the residual into the polytope.

``top_eigenpair`` estimates ‖X‖₂² by power iteration on matvecs. Its cold
start draws ``v0`` from a ``torch.Generator`` seeded with ``seed`` (on the
CPU, so the start does not depend on the device); pass ``v0`` to
warm-start or to reproduce another implementation's start exactly.
"""

from __future__ import annotations

import torch


def soft_threshold(u: torch.Tensor, thresh) -> torch.Tensor:
    """S(u, t) = sign(u)·max(|u| − t, 0)."""
    return torch.sign(u) * torch.clamp(torch.abs(u) - thresh, min=0.0)


def top_eigenpair(X: torch.Tensor, iters: int = 50, *, v0=None,
                  seed: int = 0, dtype=None):
    """(λ_max(XᵀX), eigenvector) by power iteration; never forms XᵀX.
    The eigenvalue is a 0-d tensor on X's device (no host sync)."""
    dtype = X.dtype if dtype is None else dtype
    if v0 is None:
        gen = torch.Generator().manual_seed(seed)
        v0 = torch.randn(X.shape[1], generator=gen, dtype=dtype)
    v = torch.as_tensor(v0, dtype=dtype).to(X.device)
    v = v / (torch.linalg.vector_norm(v) + 1e-30)
    for _ in range(iters):
        w = X.T @ (X @ v)
        v = w / (torch.linalg.vector_norm(w) + 1e-30)
    Xv = X @ v
    return torch.sum(Xv * Xv), v


def power_iteration(X: torch.Tensor, iters: int = 50, seed: int = 0, *,
                    v0=None, dtype=None) -> torch.Tensor:
    """Largest eigenvalue of XᵀX (= ‖X‖₂²); see :func:`top_eigenpair`."""
    return top_eigenpair(X, iters, v0=v0, seed=seed, dtype=dtype)[0]


def primal_objective(X, y, beta, lam):
    r = y - X @ beta
    return 0.5 * torch.sum(r * r) + lam * torch.sum(torch.abs(beta))


def dual_objective(y, theta, lam):
    d = theta - y / lam
    return 0.5 * torch.sum(y * y) - 0.5 * lam ** 2 * torch.sum(d * d)


def feasible_dual_point(X, y, beta, lam):
    """θ̃ = s·r/λ with s = min(1, λ/‖Xᵀr‖∞): the residual scaled into the
    dual polytope."""
    r = y - X @ beta
    corr = torch.max(torch.abs(X.T @ r))
    s = torch.clamp(lam / (corr + 1e-30), max=1.0)
    return s * r / lam


def gap_from_residual(r, dot, beta, lam, y):
    """Duality gap from r = y − Xβ and dot = Xᵀr (the two X passes hoisted
    out, so a solver can reuse them)."""
    corr = torch.max(torch.abs(dot))
    s = torch.clamp(lam / (corr + 1e-30), max=1.0)
    d = s * r - y
    return (0.5 * torch.sum(r * r) + lam * torch.sum(torch.abs(beta))
            - 0.5 * torch.sum(y * y) + 0.5 * torch.sum(d * d))


def duality_gap(X, y, beta, lam):
    r = y - X @ beta
    return gap_from_residual(r, X.T @ r, beta, lam, y)
