"""Plain PyTorch versions of the port's kernels.

These define the semantics of the hand-written CUDA kernels in
``csrc/`` and are the CPU route of every wrapper: ``edpp_screen_ref``,
``screen_matvec_ref``, ``fista_step_ref``, ``cd_gram_sweep_ref`` and
``group_screen_ref`` mirror ``repro.kernels.ref`` op for op.

Batch axis: the query operand (``centre`` for the screens, ``r``/``z``/
``beta_old`` for the solver step, ``c``/``beta``/``valid`` for the Gram
sweep) may be ``(n,)``/``(p,)`` or carry a leading batch axis B;
per-query parameters (``rho``, ``step``, ``lam``, ``mom``) are then a
scalar or a ``(B,)`` vector. X and G are never batched; the group scores
take a rank-1 centre only.

Accumulation follows :func:`_acc_dtype`: float32 for float32 (and
bfloat16) input, float64 stays float64.

``PLAIN_CALLS`` counts calls per op, so a run on the card can show that
its main path never fell back to these versions.
"""

from __future__ import annotations

import collections

import torch

PLAIN_CALLS: collections.Counter = collections.Counter()


def _acc_dtype(X: torch.Tensor) -> torch.dtype:
    """float32 for float32/bfloat16 inputs, never a downcast of float64."""
    return torch.promote_types(X.dtype, torch.float32)


def _per_query(s, batch: int, dtype, device) -> torch.Tensor:
    """Broadcast a scalar-or-(B,) per-query parameter to (B,) in dtype."""
    return torch.as_tensor(s, dtype=dtype, device=device).broadcast_to(
        (batch,))


def edpp_screen_ref(X: torch.Tensor, centre: torch.Tensor, rho):
    """Fused screening pass: ``scores[j] = |x_jᵀc| + ρ‖x_j‖``,
    ``sumsq[j] = ‖x_j‖²``. Batched centre (B, n) gives scores (B, p);
    sumsq stays (p,)."""
    PLAIN_CALLS["edpp_screen_scores"] += 1
    acc = _acc_dtype(X)
    Xa = X.to(acc)
    ca = centre.to(acc)
    sumsq = torch.sum(Xa * Xa, dim=0)
    if ca.ndim == 2:
        dot = ca @ Xa
        rho_b = _per_query(rho, ca.shape[0], acc, X.device)
        return torch.abs(dot) + rho_b[:, None] * torch.sqrt(sumsq), sumsq
    dot = Xa.T @ ca
    rho_a = torch.as_tensor(rho, dtype=acc, device=X.device)
    return torch.abs(dot) + rho_a * torch.sqrt(sumsq), sumsq


def screen_matvec_ref(X: torch.Tensor, centre: torch.Tensor) -> torch.Tensor:
    """``dot[j] = x_jᵀc``; batched centre (B, n) gives (B, p)."""
    PLAIN_CALLS["screen_matvec"] += 1
    acc = _acc_dtype(X)
    if centre.ndim == 2:
        return centre.to(acc) @ X.to(acc)
    return X.to(acc).T @ centre.to(acc)


def _prox(z, g, beta_old, step, lam, mom):
    """``β = S(z − step·g, step·λ)``, ``z' = β + mom·(β − β_old)``."""
    u = z - step * g
    t = step * lam
    beta_new = torch.sign(u) * torch.clamp(torch.abs(u) - t, min=0.0)
    return beta_new, beta_new + mom * (beta_new - beta_old)


def fista_step_ref(X: torch.Tensor, r: torch.Tensor, z: torch.Tensor,
                   beta_old: torch.Tensor, step, lam, mom):
    """One fused FISTA iteration tail given the residual ``r = Xz − y``:
    ``g = Xᵀr``, ``β = S(z − step·g, step·λ)``,
    ``z' = β + mom·(β − β_old)``. Batched: r (B, n), z/β_old (B, p),
    step/λ/mom scalar-or-(B,)."""
    PLAIN_CALLS["fista_step"] += 1
    acc = _acc_dtype(X)
    za, ba = z.to(acc), beta_old.to(acc)
    if r.ndim == 2:
        g = r.to(acc) @ X.to(acc)
        b = r.shape[0]
        step, lam, mom = (_per_query(s, b, acc, X.device)[:, None]
                          for s in (step, lam, mom))
    else:
        g = X.to(acc).T @ r.to(acc)
        step, lam, mom = (torch.as_tensor(s, dtype=acc, device=X.device)
                          for s in (step, lam, mom))
    return _prox(za, g, ba, step, lam, mom)


def group_screen_ref(X: torch.Tensor, centre: torch.Tensor,
                     m: int) -> torch.Tensor:
    """Group scores (Corollary 21 LHS): ``gscores[g] = ‖X_gᵀc‖₂`` over
    contiguous groups of m columns; rank-1 centre, (p/m,) out."""
    PLAIN_CALLS["group_screen_scores"] += 1
    acc = _acc_dtype(X)
    dot = X.to(acc).T @ centre.to(acc)
    return torch.linalg.vector_norm(dot.reshape(-1, m), dim=1)


def cd_gram_sweep_ref(G: torch.Tensor, c: torch.Tensor, beta: torch.Tensor,
                      lam, sweeps: int = 1,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    """``sweeps`` cyclic coordinate-descent sweeps over the Gram system
    G = XᵀX, c = Xᵀy, with q = βG kept incrementally:

        ρ_j  = c_j − q_j + G_jj·β_j
        β_j' = S(ρ_j, λ) / G_jj          (0 where G_jj = 0: padded columns)
        q   += G_:,j·(β_j' − β_j)

    Batched: c/β (B, p) share the (p, p) G, λ is scalar-or-(B,), and
    ``valid`` (β's shape, {0, 1}) pins each query's screened-out columns
    at 0. One coordinate at a time, as the kernel runs it."""
    PLAIN_CALLS["cd_gram_sweep"] += 1
    p = G.shape[0]
    beta = beta.clone()
    batched = beta.dim() == 2
    lam_t = (_per_query(lam, beta.shape[0], beta.dtype, beta.device)
             if batched else torch.as_tensor(lam, dtype=beta.dtype,
                                             device=beta.device))
    q = beta @ G if batched else G @ beta
    for i in range(sweeps * p):
        j = i % p
        gjj = G[j, j]
        bj = beta[..., j]
        rho = c[..., j] - q[..., j] + gjj * bj
        bn = torch.where(
            gjj > 0,
            torch.sign(rho) * torch.clamp(torch.abs(rho) - lam_t, min=0.0)
            / torch.clamp(gjj, min=1e-30),
            torch.zeros_like(rho))
        if valid is not None:
            bn = bn * valid[..., j]
        delta = bn - bj
        q = q + (G[:, j] * delta[:, None] if batched else G[:, j] * delta)
        beta[..., j] = bn
    return beta
