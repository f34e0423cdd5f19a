"""Plain PyTorch versions of the port's kernels.

These define the semantics of the hand-written CUDA kernels in
``csrc/`` and are the CPU route of every wrapper: ``edpp_screen_ref``,
``screen_matvec_ref``, ``fista_step_ref``, ``prox_step_ref``,
``cd_gram_sweep_ref`` and ``group_screen_ref`` mirror
``repro.kernels.ref`` op for op.

Batch axis: the query operand (``centre`` for the screens, ``r``/``z``/
``beta_old`` for the solver step, ``z``/``g``/``beta_old`` for the prox
step, ``c``/``beta``/``valid`` for the Gram
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


def sum_rows(P: torch.Tensor) -> torch.Tensor:
    """``P.sum(0)`` for P (n, p) by a fixed tree of elementwise additions
    (each step adds the lower half of the rows to the upper half; an odd
    row carries to the next step). Every column's sum is the same
    sequence of roundings whatever the other columns, on any device, so
    the sums of an (n, k) gather of columns are bit for bit those of the
    whole width at the gathered columns (a library reduction picks its
    order by the shape and does not keep that)."""
    if P.shape[0] == 0:
        return P.new_zeros((P.shape[1],))
    while P.shape[0] > 1:
        h = P.shape[0] // 2
        top = P[:h] + P[h:2 * h]
        P = torch.cat([top, P[2 * h:]]) if P.shape[0] % 2 else top
    return P[0]


def column_dots(X: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``dot[j] = x_jᵀc`` for X (n, p) and c (n,) in X's dtype: the n
    products of each column, rounded once each, summed by
    :func:`sum_rows`, so the dots of an (n, k) gather of X are bit for
    bit those of the whole X at the gathered columns (a BLAS
    matrix-vector product blocks by p and does not keep that)."""
    return sum_rows(X * c[:, None])


def column_sumsq(X: torch.Tensor) -> torch.Tensor:
    """``‖x_j‖²`` for X (n, p): each square rounded once, summed by
    :func:`sum_rows`, so a block of columns gets the whole width's bits
    (a dictionary update's added block, the rank's block of a mesh)."""
    return sum_rows(X * X)


def _rowwise_dots(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """(B, p) dots of each centre row with X, :func:`column_dots` per row:
    a query's dots are those of the rank-1 call, whatever the batch
    around it (the kernels' bits do not depend on B either)."""
    return torch.stack([column_dots(X, c) for c in C]) if len(C) else \
        C.new_zeros((0, X.shape[1]))


def edpp_screen_ref(X: torch.Tensor, centre: torch.Tensor, rho, *,
                    wide_p: int | None = None):
    """Fused screening pass: ``scores[j] = |x_jᵀc| + ρ‖x_j‖``,
    ``sumsq[j] = ‖x_j‖²``. Batched centre (B, n) gives scores (B, p);
    sumsq stays (p,). ``wide_p`` (the kernel's order of a wider pass)
    changes nothing here: these sums do not depend on the width
    (:func:`column_dots`, :func:`column_sumsq`)."""
    PLAIN_CALLS["edpp_screen_scores"] += 1
    acc = _acc_dtype(X)
    Xa = X.to(acc)
    ca = centre.to(acc)
    sumsq = column_sumsq(Xa)
    if ca.ndim == 2:
        dot = _rowwise_dots(Xa, ca)
        rho_b = _per_query(rho, ca.shape[0], acc, X.device)
        return torch.abs(dot) + rho_b[:, None] * torch.sqrt(sumsq), sumsq
    dot = column_dots(Xa, ca)
    rho_a = torch.as_tensor(rho, dtype=acc, device=X.device)
    return torch.abs(dot) + rho_a * torch.sqrt(sumsq), sumsq


def screen_matvec_ref(X: torch.Tensor, centre: torch.Tensor, *,
                      wide_p: int | None = None) -> torch.Tensor:
    """``dot[j] = x_jᵀc``; batched centre (B, n) gives (B, p). X may be
    the bf16 screen copy (summed in float32 over ``X.float()``).
    ``wide_p`` (the kernel's re-test order) changes nothing here: these
    sums do not depend on the width (:func:`column_dots`)."""
    PLAIN_CALLS["screen_matvec"] += 1
    acc = _acc_dtype(X)
    if centre.ndim == 2:
        return _rowwise_dots(X.to(acc), centre.to(acc))
    return column_dots(X.to(acc), centre.to(acc))


def _prox(z, g, beta_old, step, lam, mom):
    """``β = S(z − step·g, step·λ)``, ``z' = β + mom·(β − β_old)``; the
    parameters come as tensors of z's dtype, shaped to broadcast."""
    u = z - step * g
    t = step * lam
    beta_new = torch.sign(u) * torch.clamp(torch.abs(u) - t, min=0.0)
    return beta_new, beta_new + mom * (beta_new - beta_old)


def _prox_params(z: torch.Tensor, step, lam, mom, params=None):
    """step, λ, mom as tensors of z's dtype: (B, 1) for a (B, p) z, 0-d
    for a (p,) z, so ``step·λ`` rounds in that dtype, as the kernels
    compute it. ``params``, a (3, B) block of step | λ | mom rows (B = 1
    for a (p,) z), replaces the three when given."""
    if params is not None:
        B = z.shape[0] if z.dim() == 2 else 1
        if tuple(params.shape) != (3, B):
            raise ValueError(f"params must be (3, {B}): step | lam | mom, "
                             f"got {tuple(params.shape)}")
        step, lam, mom = params if z.dim() == 2 else params[:, 0]
    elif step is None or lam is None or mom is None:
        raise TypeError("give step, lam and mom, or params")
    if z.dim() == 2:
        return tuple(_per_query(s, z.shape[0], z.dtype, z.device)[:, None]
                     for s in (step, lam, mom))
    return tuple(torch.as_tensor(s, dtype=z.dtype, device=z.device)
                 for s in (step, lam, mom))


def _sum_parts(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient from ``g``: itself when it has z's shape, else the sum
    of its parts along the leading axis, in index order, one rounded
    addition at a time (the reference's ``functools.reduce(jnp.add,
    parts)``), in z's dtype."""
    g = g.to(z.dtype)
    if g.dim() == z.dim():
        return g
    total = g[0]
    for part in g[1:]:
        total = total + part
    return total


def prox_step_ref(z: torch.Tensor, g: torch.Tensor, beta_old: torch.Tensor,
                  step=None, lam=None, mom=None, *, params=None):
    """The FISTA prox and momentum over p-vectors, given the gradient g:

        u  = z − step·g
        β' = sign(u)·max(|u| − step·λ, 0)
        z' = β' + mom·(β' − β_old)

    z/g/beta_old are (p,) or (B, p) with step/λ/mom scalar-or-(B,), or
    ``params`` a (3, B) block of them; g may also be a (k, …) stack of
    the gradient's parts, summed in index order first (:func:`_sum_parts`).
    The result has z's dtype. Zero columns (z = g = β_old = 0) stay 0."""
    PLAIN_CALLS["prox_step"] += 1
    return _prox(z, _sum_parts(z, g), beta_old.to(z.dtype),
                 *_prox_params(z, step, lam, mom, params))


def fista_step_ref(X: torch.Tensor, r: torch.Tensor, z: torch.Tensor,
                   beta_old: torch.Tensor, step=None, lam=None, mom=None, *,
                   params=None):
    """One fused FISTA iteration tail given the residual ``r = Xz − y``:
    ``g = Xᵀr``, ``β = S(z − step·g, step·λ)``,
    ``z' = β + mom·(β − β_old)``. Batched: r (B, n), z/β_old (B, p),
    step/λ/mom scalar-or-(B,), or ``params`` a (3, B) block of them."""
    PLAIN_CALLS["fista_step"] += 1
    acc = _acc_dtype(X)
    za, ba = z.to(acc), beta_old.to(acc)
    if r.ndim == 2:
        g = r.to(acc) @ X.to(acc)
    else:
        g = X.to(acc).T @ r.to(acc)
    return _prox(za, g, ba, *_prox_params(za, step, lam, mom, params))


def group_screen_ref(X: torch.Tensor, centre: torch.Tensor, m: int, *,
                     wide_p: int | None = None) -> torch.Tensor:
    """Group scores (Corollary 21 LHS): ``gscores[g] = ‖X_gᵀc‖₂`` over
    contiguous groups of m columns; rank-1 centre, (p/m,) out. The dots
    sum by :func:`column_dots` and each group's squares by
    :func:`sum_rows` (the m squares of a group as rows), so a block of
    whole groups gets the whole width's bits (a mesh rank's block).
    ``wide_p`` (the kernel's order of a wider pass) changes nothing
    here."""
    PLAIN_CALLS["group_screen_scores"] += 1
    acc = _acc_dtype(X)
    dot = column_dots(X.to(acc), centre.to(acc))
    return torch.sqrt(sum_rows((dot * dot).reshape(-1, m).T))


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
