"""SolverEngine: the reduced solves of the λ-path behind a registry.

Strategies are registered in ``SOLVERS`` (``register_solver``):

* ``fista``: each iteration is one forward fit ``X @ z``
  (``torch.matmul``, as the reference left it to XLA) and one fused
  ``fista_step`` kernel pass (gradient + prox + momentum).
* ``cd``: coordinate descent. Up to the Gram crossover
  (bucket ≤ min(n, ``GRAM_BUCKET_MAX``)) it builds G = XᵀX and c = Xᵀy
  once per solve (``torch.matmul``) and sweeps them with the
  ``cd_gram_sweep`` kernel, ``gap_check_cadence`` sweeps per launch;
  above it, matvec CD in plain torch (the reference has no kernel for it
  either: its column access is sequential), one coordinate at a time.
* ``group_fista``: block FISTA for the group Lasso, plain torch (two
  matmuls and the block soft-threshold per iteration), as the
  reference's body is plain jnp on every backend.

The reference runs each loop on the device (``lax.while_loop``). Here the
host drives it in blocks of ``gap_check_cadence`` iterations (sweeps,
epochs): nothing in a block waits for the device — FISTA's momentum
sequence t_k does not depend on the data, so ``mom`` is a host float
(computed in float32, as the reference computes it) and every kernel
argument is passed by value — and each duality-gap check costs one
``.item()`` sync. FISTA's step 1/L costs one more sync per solve.

``SolverEngine.lipschitz`` caches the top eigenvector per bucket size and
warm-starts power iteration from it; ``eig_cache`` lets a session share
that cache across engines (and ``session_from_arrays`` carry one over
from the reference).

**Batched solves** (``SolverEngine(Y)`` with Y (B, n),
:meth:`SolverEngine.solve_batched`): B queries share one bucket, the
union of what any of them kept, and ``valid`` (B, b) pins the columns
each query screened out at 0. ``BATCHED_SOLVERS`` holds the twins of
``fista`` and ``cd``; every launch serves the whole batch:

* ``fista``: one step 1/L for the union bucket and one momentum
  sequence, per-query λ; each iteration one ``torch.matmul`` for the
  (B, n) fits and one ``fista_step`` launch, its step | λ | mom read
  from a row of a (iterations, 3, B) table uploaded once per solve;
* ``cd``: one G = XᵀX of the bucket and C = Y·X (B, b), then one
  ``cd_gram_sweep`` launch at B with ``valid`` per gap check (matvec CD,
  plain torch, above the crossover).

A query whose gap met its tolerance is frozen: its β (and z) are kept
bit for bit through the rest of the batch's iterations, and its
iteration count stops. The gap is checked for the whole batch at once,
one host sync per check. A strategy registered without a batched twin
runs once per query on the bucket with that query's columns zeroed
(the reference's fallback).

**Mixed-precision solves** (``SolverEngine(..., solve_dtype="bfloat16")``,
the reference's two-phase strategies): ``fista`` and Gram ``cd`` first
run a bf16 phase on the bucket's bf16 copy X̃ (``lo``: the triple
``(X̃, col_err, col_norms)`` the path gathers from the session's bf16
copy, else made from Xr), then polish in float32 from its β, unless the
bf16 phase already converged. In the bf16 phase FISTA's ``fista_step``
reads X̃ (launched as ``fista_step_bf16``) and the forward fit reads X̃
widened to float32 once per solve (``torch.matmul`` takes one dtype, and
rounding z to bf16 would change the reference's values, XLA's bf16 X̃
times float32 z); Gram CD builds G̃ = X̃ᵀX̃ and c̃ = X̃ᵀy in float32 from
that widened copy and sweeps them with the float32 ``cd_gram_sweep``.
Every gap certificate reads the float32 Xr, so a stop at the tolerance
is true convergence; the phase also hands over when the gap has stalled
under ``ops.BF16_SOLVE_SLACK`` × its certified budget
(``ops.bf16_certified_stop``, evaluated in float32 on the host: the gap
and the budget come back in one sync per check). ``group_fista`` has no
bf16 phase: it warns once and solves in float32; matvec CD past the Gram
crossover solves in float32 and only records it
(``last_effective_dtype``).
"""

from __future__ import annotations

import functools
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..kernels import ops
from .device import as_tensor, resolve_device
from .group_lasso import group_gap_from_residual, group_soft_threshold
from .lasso import gap_from_residual, top_eigenpair

_F32 = np.float32


def host_float(X: torch.Tensor):
    """The numpy scalar type FISTA's host-side numbers round in: float32
    for float32 X (as the reference computes them), else float64."""
    return _F32 if X.dtype == torch.float32 else np.float64


def fista_step_size(lipschitz, fl) -> float:
    """FISTA's step 1/max(L, 1e-12), rounded in ``fl``."""
    return float(fl(1.0) / fl(max(float(lipschitz), 1e-12)))


def fista_momentum(t, fl):
    """FISTA's next t and the momentum (t − 1)/t', in ``fl`` on the host:
    the sequence does not depend on the data, so no iteration waits on
    the device."""
    t_new = fl(0.5) * (fl(1.0) + np.sqrt(fl(1.0) + fl(4.0) * t * t))
    return t_new, float((t - fl(1.0)) / t_new)


class SolveResult(NamedTuple):
    """One reduced solve: β (on the device) and host-side telemetry.
    Batched: β (B, b), and gap, iters, converged host (B,) arrays."""

    beta: torch.Tensor
    gap: float | np.ndarray
    iters: int | np.ndarray
    converged: bool | np.ndarray
    gap_checks: int = 0


# The reference's names for the result of its one-shot solvers.
FistaResult = SolveResult
GroupFistaResult = SolveResult


# The solver backend a solve takes when none is named (``cuda`` on the
# card, the default device; ``torch`` on the CPU), and a name's backend:
# the screens' registry and policy (a registered backend runs only where
# it is named).
default_solver_backend = ops.default_backend_name
resolve_solver_backend = ops.resolve_backend


def momentum_sequence(iters: int, fl) -> np.ndarray:
    """FISTA's momentum (t − 1)/t' for iterations 0 … iters − 1 from
    t = 1, by :func:`fista_momentum` in ``fl``: the numbers an eager loop
    computes one per iteration (made once per length, then copied)."""
    return _momentum_sequence(int(iters), fl).copy()


@functools.lru_cache(maxsize=16)
def _momentum_sequence(iters: int, fl) -> np.ndarray:
    moms = np.empty(iters, dtype=fl)
    t = fl(1.0)
    for i in range(iters):
        t, moms[i] = fista_momentum(t, fl)
    return moms


def _fista_solve(step_op: Callable, X, y, lam: float, beta0, lipschitz: float,
                 tol: float, max_iter: int, cadence: int) -> SolveResult:
    """FISTA with the fused gradient+prox+momentum kernel per iteration.

    ``tol`` is a relative gap tolerance: stop when gap ≤ tol·½‖y‖². The
    gap is checked before the first block and after every block of
    ``cadence`` iterations, so ``iters`` is a multiple of ``cadence``.
    Zero columns are fixed points, so padded buckets pass through."""
    fl = host_float(X)
    step = fista_step_size(lipschitz, fl)
    thresh = tol * (0.5 * float(torch.sum(y * y)) + 1e-30)

    def gap_of(beta) -> float:
        r = y - X @ beta
        return float(gap_from_residual(r, X.T @ r, beta, lam, y))

    beta, z, t = beta0, beta0, fl(1.0)
    k, gap, checks = 0, gap_of(beta0), 1
    while k < max_iter and gap > thresh:
        for _ in range(cadence):
            rz = X @ z - y
            t, mom = fista_momentum(t, fl)
            beta, z = step_op(X, rz, z, beta, step, lam, mom)
        k += cadence
        gap = gap_of(beta)
        checks += 1
    return SolveResult(beta, gap, k, gap <= thresh, checks)


def _cd_solve(X, y, lam: float, beta0, tol: float, max_epochs: int,
              cadence: int) -> SolveResult:
    """Cyclic coordinate descent on matvecs (residual maintained), plain
    torch: β_j ← S(x_jᵀr + ‖x_j‖²β_j, λ)/‖x_j‖², one coordinate at a time;
    zero-norm (padded) columns stay at 0. The gap is checked every
    ``cadence`` epochs from a fresh residual (the carried one drifts by
    rounding)."""
    p = X.shape[1]
    sqnorms = torch.sum(X * X, dim=0)
    live = [j for j, nj in enumerate(sqnorms.tolist()) if nj > 0]
    thresh = tol * (0.5 * float(torch.sum(y * y)) + 1e-30)

    def gap_of(beta) -> float:
        r = y - X @ beta
        return float(gap_from_residual(r, X.T @ r, beta, lam, y))

    beta = beta0.clone()
    if len(live) < p:                 # zero columns are pinned at 0
        keep = torch.zeros((p,), dtype=torch.bool, device=X.device)
        keep[live] = True
        beta = beta * keep
    r = y - X @ beta
    k, gap, checks = 0, gap_of(beta), 1
    while k < max_epochs and gap > thresh:
        for _ in range(cadence):
            for j in live:
                xj, bj, nj = X[:, j], beta[j], sqnorms[j]
                rho = torch.dot(xj, r) + nj * bj
                bn = torch.sign(rho) * torch.clamp(torch.abs(rho) - lam,
                                                   min=0.0) / nj
                r = r + xj * (bj - bn)
                beta[j] = bn
        k += cadence
        gap = gap_of(beta)
        checks += 1
    return SolveResult(beta, gap, k, gap <= thresh, checks)


def _cd_gram_solve(sweep_op: Callable, X, y, lam: float, beta0, tol: float,
                   max_epochs: int, cadence: int) -> SolveResult:
    """Coordinate descent over the Gram system: G = XᵀX and c = Xᵀy once
    (one pass over the bucket), then one ``cd_gram_sweep`` launch of
    ``cadence`` sweeps per gap check. The gap recomputes the residual from
    X (no ‖y‖² − 2cᵀβ + βᵀGβ cancellation at tight tolerances)."""
    G = X.T @ X
    c = X.T @ y
    thresh = tol * (0.5 * float(torch.sum(y * y)) + 1e-30)

    def gap_of(beta) -> float:
        r = y - X @ beta
        return float(gap_from_residual(r, X.T @ r, beta, lam, y))

    beta = beta0
    k, gap, checks = 0, gap_of(beta0), 1
    while k < max_epochs and gap > thresh:
        beta = sweep_op(G, c, beta, lam, sweeps=cadence)
        k += cadence
        gap = gap_of(beta)
        checks += 1
    return SolveResult(beta, gap, k, gap <= thresh, checks)


def _group_fista_solve(X, y, lam: float, m: int, beta0, lipschitz: float,
                       tol: float, max_iter: int,
                       cadence: int) -> SolveResult:
    """Block FISTA for the group Lasso, plain torch: g = Xᵀ(Xz − y), the
    block soft-threshold, momentum. Zero-padded groups are fixed points,
    so group buckets pass through."""
    fl = host_float(X)
    step = fista_step_size(lipschitz, fl)
    thresh = tol * (0.5 * float(torch.sum(y * y)) + 1e-30)

    def gap_of(beta) -> float:
        r = y - X @ beta
        return float(group_gap_from_residual(r, X.T @ r, beta, lam, m, y))

    beta, z, t = beta0, beta0, fl(1.0)
    k, gap, checks = 0, gap_of(beta0), 1
    while k < max_iter and gap > thresh:
        for _ in range(cadence):
            g = X.T @ (X @ z - y)
            beta_new = group_soft_threshold(z - step * g, step * lam, m)
            t, mom = fista_momentum(t, fl)
            z = beta_new + mom * (beta_new - beta)
            beta = beta_new
        k += cadence
        gap = gap_of(beta)
        checks += 1
    return SolveResult(beta, gap, k, gap <= thresh, checks)


# ---------------------------------------------------------------------------
# Batched bodies: B queries against one bucket Xr (the union of what any
# of them kept); ``valid`` (B, b) ∈ {0, 1} pins each query's screened-out
# columns; a converged query is a fixed point of the batch's further
# iterations.
# ---------------------------------------------------------------------------

def _gap_from_residual_batched(r, dot, beta, lam, y):
    """Per-query duality gaps (B,) from r (B, n) and dot = rX (B, b): the
    arithmetic of :func:`~.lasso.gap_from_residual` per row, with λ (B,).
    The sup runs over every column of the bucket, those a query discarded
    included, as the reference's does."""
    corr = torch.amax(torch.abs(dot), dim=-1)
    s = torch.clamp(lam / (corr + 1e-30), max=1.0)
    d = s[:, None] * r - y
    return (0.5 * torch.sum(r * r, dim=-1)
            + lam * torch.sum(torch.abs(beta), dim=-1)
            - 0.5 * torch.sum(y * y, dim=-1) + 0.5 * torch.sum(d * d, dim=-1))


class _Batch:
    """The host side of a batched solve: per-query λ on the device, the
    gap thresholds tol·(½‖y_b‖² + 1e-30), and the convergence bookkeeping
    (``conv``, per-query ``iters``, one host sync per gap check)."""

    def __init__(self, X, Y, lam, tol: float):
        self.X, self.Y = X, Y
        self.lam_host = np.asarray(lam, dtype=np.float64).reshape(-1)
        self.lam = torch.as_tensor(self.lam_host, dtype=X.dtype,
                                   device=X.device)
        ysq = torch.sum(Y * Y, dim=-1).cpu().numpy().astype(np.float64)
        self.thresh = tol * (0.5 * ysq + 1e-30)
        B = Y.shape[0]
        self.conv = np.zeros((B,), dtype=bool)
        self.iters = np.zeros((B,), dtype=np.int64)
        self.gap = np.zeros((B,), dtype=np.float64)
        self.checks = 0

    def check(self, beta) -> None:
        r = self.Y - beta @ self.X.T
        gap = _gap_from_residual_batched(r, r @ self.X, beta, self.lam,
                                         self.Y)
        self.gap = gap.cpu().numpy().astype(np.float64)
        self.conv |= self.gap <= self.thresh
        self.checks += 1

    def frozen(self):
        """The converged rows as a (B, 1) device mask, None if none is."""
        if not self.conv.any():
            return None
        return torch.from_numpy(self.conv).to(self.X.device)[:, None]

    def advance(self, cadence: int) -> None:
        self.iters += np.where(self.conv, 0, cadence)

    def result(self, beta) -> SolveResult:
        return SolveResult(beta, self.gap.copy(), self.iters.copy(),
                           self.gap <= self.thresh, self.checks)


def _fista_solve_batched(step_op: Callable, X, Y, lam, beta0, valid,
                         lipschitz: float, tol: float, max_iter: int,
                         cadence: int) -> SolveResult:
    """FISTA for B queries on one bucket: one step 1/L and one momentum
    sequence for all, per-query λ. Each iteration: ``fista_step``, then
    β, z ·= valid, then the converged rows keep their β and z."""
    from .graphs import param_table
    step = fista_step_size(lipschitz, host_float(X))
    bt = _Batch(X, Y, lam, tol)
    table = param_table(-(-max_iter // cadence) * cadence, step,
                        bt.lam_host, Y.shape[0], X)

    beta, z, k = beta0, beta0, 0
    bt.check(beta)
    while k < max_iter and not bt.conv.all():
        beta, z = _fista_block(step_op, X, X, Y, beta, z, valid,
                               bt.frozen(), table[k:k + cadence])
        bt.advance(cadence)
        k += cadence
        bt.check(beta)
    return bt.result(beta)


def _fista_block(step_op: Callable, X_step, X_fit, Y, beta, z, valid,
                 frozen, rows):
    """One block of batched FISTA iterations, one per row of step | λ |
    mom: the fit ``z·X_fitᵀ − Y``, ``fista_step`` on ``X_step``, then
    β, z ·= valid and the ``frozen`` rows (a (B, 1) mask, or None) kept
    as they were."""
    for row in rows:
        beta_new, z_new = step_op(X_step, z @ X_fit.T - Y, z, beta,
                                  params=row)
        if valid is not None:
            beta_new, z_new = beta_new * valid, z_new * valid
        if frozen is not None:
            beta_new = torch.where(frozen, beta, beta_new)
            z_new = torch.where(frozen, z, z_new)
        beta, z = beta_new, z_new
    return beta, z


def _cd_gram_solve_batched(sweep_op: Callable, X, Y, lam, beta0, valid,
                           tol: float, max_epochs: int,
                           cadence: int) -> SolveResult:
    """Gram CD for B queries: one G = XᵀX of the bucket for all, C = Y·X
    (B, b), then one ``cd_gram_sweep`` launch of ``cadence`` sweeps at B
    (per-query λ and ``valid``) per gap check."""
    G = X.T @ X
    C = Y @ X
    bt = _Batch(X, Y, lam, tol)
    beta, k = beta0, 0
    bt.check(beta)
    while k < max_epochs and not bt.conv.all():
        frozen = bt.frozen()
        beta_new = sweep_op(G, C, beta, bt.lam, sweeps=cadence, valid=valid)
        beta = beta_new if frozen is None else torch.where(frozen, beta,
                                                           beta_new)
        bt.advance(cadence)
        k += cadence
        bt.check(beta)
    return bt.result(beta)


def _cd_solve_batched(X, Y, lam, beta0, valid, tol: float, max_epochs: int,
                      cadence: int) -> SolveResult:
    """Matvec CD for B queries, plain torch: each coordinate update reads
    x_j once for all B residual rows; converged rows discard the block's
    updates."""
    sqnorms = torch.sum(X * X, dim=0)
    live = [j for j, nj in enumerate(sqnorms.tolist()) if nj > 0]
    bt = _Batch(X, Y, lam, tol)
    beta = beta0 * (sqnorms > 0)          # zero columns are pinned at 0
    if valid is not None:
        beta = beta * valid
    r = Y - beta @ X.T
    k = 0
    bt.check(beta)
    while k < max_epochs and not bt.conv.all():
        frozen = bt.frozen()
        beta_new, r_new = beta.clone(), r
        for _ in range(cadence):
            for j in live:
                xj, bj, nj = X[:, j], beta_new[:, j].clone(), sqnorms[j]
                rho = r_new @ xj + nj * bj
                bn = torch.sign(rho) * torch.clamp(torch.abs(rho) - bt.lam,
                                                   min=0.0) / nj
                if valid is not None:
                    bn = bn * valid[:, j]
                r_new = r_new + xj[None, :] * (bj - bn)[:, None]
                beta_new[:, j] = bn
        if frozen is not None:
            beta_new = torch.where(frozen, beta, beta_new)
            r_new = torch.where(frozen, r, r_new)
        beta, r = beta_new, r_new
        bt.advance(cadence)
        k += cadence
        bt.check(beta)
    return bt.result(beta)


# ---------------------------------------------------------------------------
# The bf16 phases of the mixed-precision solve: iterations (FISTA) or the
# Gram build (CD) on the bucket's bf16 copy X̃, β and every sum in float32,
# each gap certificate from the float32 bucket X.
# ---------------------------------------------------------------------------

class _LoCheck:
    """The certificate of a bf16 phase, one query (y (n,), λ a host
    number) or a batch (y (B, n), λ a (B,) device tensor): the exact gap
    from the float32 bucket X, the budget of :func:`ops.bf16_gap_budget`,
    the threshold tol·(½‖y‖² + 1e-30) in float32 (as the reference's
    ``tol * scale``), fetched together in one host sync per check, and
    :func:`ops.bf16_certified_stop` on them in float32."""

    def __init__(self, X, y, lam, tol: float, err_max, cn_max):
        self.X, self.y, self.lam = X, y, lam
        self.err_max, self.cn_max = err_max, cn_max
        yf = y.to(torch.float32)
        self._thresh_dev = tol * (0.5 * torch.sum(yf * yf, dim=-1) + 1e-30)
        self.thresh = None
        self.prev = None

    def __call__(self, beta):
        """(gap, stop) of β, float32 CPU tensors shaped like λ."""
        X, y = self.X, self.y
        bx = beta.to(X.dtype)
        if y.dim() == 2:
            r = y - bx @ X.T
            gap = _gap_from_residual_batched(r, r @ X, bx, self.lam, y)
        else:
            r = y - X @ bx
            gap = gap_from_residual(r, X.T @ r, bx, self.lam, y)
        budget = ops.bf16_gap_budget(
            torch.linalg.vector_norm(r, dim=-1).to(torch.float32),
            torch.sum(torch.abs(bx), dim=-1).to(torch.float32),
            self.err_max, self.cn_max)
        parts = [gap.to(torch.float32), budget.to(torch.float32)]
        if self.thresh is None:
            parts.append(self._thresh_dev)
        host = torch.stack(parts).cpu()
        gap, budget = host[0], host[1]
        if self.thresh is None:
            self.thresh = host[2]
            self.prev = torch.full_like(gap, float("inf"))
        stop = ops.bf16_certified_stop(gap, budget, self.prev, self.thresh)
        self.prev = gap
        return gap, stop


def _fista_solve_lo(step_op: Callable, X, X_lo, y, lam: float, beta0,
                    lipschitz: float, tol: float, max_iter: int,
                    cadence: int, err_max, cn_max) -> SolveResult:
    """The bf16 phase of FISTA: :func:`_fista_solve`'s iteration with
    ``fista_step`` on the bf16 bucket ``X_lo`` and the forward fit on its
    float32 widening, β and z float32; stops when
    :func:`ops.bf16_certified_stop` says so (checked before the first
    block, with prev_gap = inf, and after every block)."""
    Xw = X_lo.to(torch.float32)        # the forward fit's operand, once
    yf = y.to(torch.float32)
    step = fista_step_size(lipschitz, _F32)
    cert = _LoCheck(X, y, lam, tol, err_max, cn_max)
    beta = z = beta0.to(torch.float32)
    t = _F32(1.0)
    gap, done = cert(beta)
    k, checks = 0, 1
    while k < max_iter and not bool(done):
        for _ in range(cadence):
            rz = Xw @ z - yf
            t, mom = fista_momentum(t, _F32)
            beta, z = step_op(X_lo, rz, z, beta, step, lam, mom)
        k += cadence
        gap, done = cert(beta)
        checks += 1
    return SolveResult(beta, float(gap), k, bool(gap <= cert.thresh),
                       checks)


def _fista_solve_lo_batched(step_op: Callable, X, X_lo, Y, lam, beta0,
                            valid, lipschitz: float, tol: float,
                            max_iter: int, cadence: int, err_max,
                            cn_max) -> SolveResult:
    """The batched twin of :func:`_fista_solve_lo`: step | λ | mom from a
    :func:`~.graphs.param_table`, β, z ·= valid, and a query freezes once
    its own certified stop holds (converged, or stalled under its own
    budget)."""
    from .graphs import param_table
    Xw = X_lo.to(torch.float32)
    Yf = Y.to(torch.float32)
    step = fista_step_size(lipschitz, _F32)
    bt = _Batch(X, Y, lam, tol)
    cert = _LoCheck(X, Y, bt.lam, tol, err_max, cn_max)
    table = param_table(-(-max_iter // cadence) * cadence, step,
                        bt.lam_host, Y.shape[0], Xw)
    beta = z = beta0.to(torch.float32)
    gap, stop = cert(beta)
    bt.conv |= stop.numpy()
    k, checks = 0, 1
    while k < max_iter and not bt.conv.all():
        beta, z = _fista_block(step_op, X_lo, Xw, Yf, beta, z, valid,
                               bt.frozen(), table[k:k + cadence])
        bt.advance(cadence)
        k += cadence
        gap, stop = cert(beta)
        bt.conv |= stop.numpy()
        checks += 1
    return SolveResult(beta, gap.numpy().astype(np.float64), bt.iters.copy(),
                       (gap <= cert.thresh).numpy(), checks)


def _cd_gram_solve_lo(sweep_op: Callable, X, X_lo, y, lam: float, beta0,
                      tol: float, max_epochs: int, cadence: int, err_max,
                      cn_max) -> SolveResult:
    """The bf16 phase of Gram CD: G̃ = X̃ᵀX̃ and c̃ = X̃ᵀy built in
    float32 from the widened bf16 bucket, swept by ``cd_gram_sweep`` as in
    :func:`_cd_gram_solve`, under :func:`ops.bf16_certified_stop` (the
    sweep's gradient G̃β − c̃ = X̃ᵀ(X̃β − y) is what the budget bounds)."""
    Xl = X_lo.to(X.dtype)
    G = Xl.T @ Xl
    c = Xl.T @ y
    cert = _LoCheck(X, y, lam, tol, err_max, cn_max)
    beta = beta0
    gap, done = cert(beta)
    k, checks = 0, 1
    while k < max_epochs and not bool(done):
        beta = sweep_op(G, c, beta, lam, sweeps=cadence)
        k += cadence
        gap, done = cert(beta)
        checks += 1
    return SolveResult(beta, float(gap), k, bool(gap <= cert.thresh),
                       checks)


def _cd_gram_solve_lo_batched(sweep_op: Callable, X, X_lo, Y, lam, beta0,
                              valid, tol: float, max_epochs: int,
                              cadence: int, err_max, cn_max) -> SolveResult:
    """The batched twin of :func:`_cd_gram_solve_lo`: one G̃ of the bf16
    bucket for all B queries, C̃ = Y·X̃ (B, b), one ``cd_gram_sweep``
    launch at B per check, each query frozen once its own certified stop
    holds."""
    Xl = X_lo.to(X.dtype)
    G = Xl.T @ Xl
    C = Y @ Xl
    bt = _Batch(X, Y, lam, tol)
    cert = _LoCheck(X, Y, bt.lam, tol, err_max, cn_max)
    beta = beta0
    gap, stop = cert(beta)
    bt.conv |= stop.numpy()
    k, checks = 0, 1
    while k < max_epochs and not bt.conv.all():
        frozen = bt.frozen()
        beta_new = sweep_op(G, C, beta, bt.lam, sweeps=cadence, valid=valid)
        beta = beta_new if frozen is None else torch.where(frozen, beta,
                                                           beta_new)
        bt.advance(cadence)
        k += cadence
        gap, stop = cert(beta)
        bt.conv |= stop.numpy()
        checks += 1
    return SolveResult(beta, gap.numpy().astype(np.float64), bt.iters.copy(),
                       (gap <= cert.thresh).numpy(), checks)


# A strategy is ``(engine, Xr, lam, beta0, m) -> (SolveResult, info)``
# with info = {"gram": bool}: whether the solve ran on the Gram system;
# the two-phase strategies add "lo_iters" and "lo_checks" (the bf16
# phase's), batched FISTA "hi_iters" (the polish's), and Gram CD
# "lo_passes" and "x_passes" (its own pass count: two G builds on a
# handover). The reference's accounting (``src/repro/core/solver.py``).

_BF16_SOLVE_WARNED: set[str] = set()


def _note_solve_f32_fallback(strategy: str) -> None:
    """One warning per strategy and process: ``solve_dtype="bfloat16"``
    was asked of a strategy with no certified bf16 phase, which solves
    in float32."""
    if strategy in _BF16_SOLVE_WARNED:
        return
    _BF16_SOLVE_WARNED.add(strategy)
    warnings.warn(
        f"solve_dtype='bfloat16' has no certified low-precision phase for "
        f"solver strategy {strategy!r}; solving in float32 instead "
        f"(results unchanged, no byte saving)", RuntimeWarning,
        stacklevel=4)


def _lo_result(res: SolveResult, Xr) -> SolveResult:
    """A bf16 phase's result with β in the bucket's dtype."""
    return res._replace(beta=res.beta.to(Xr.dtype))


def _fista_strategy(eng: "SolverEngine", Xr, lam, beta0, m: int):
    """FISTA; on a bf16 engine the bf16 phase first, then the float32
    polish from its β unless it converged (one step 1/L for both)."""
    L = eng.lipschitz(Xr)
    lo = eng._take_lo()
    lo_it = lo_ck = 0
    if lo is not None:
        res_lo = _lo_result(_fista_solve_lo(
            eng.backend.fista_step, Xr, lo[0], eng.y, lam, beta0, L,
            eng.tol, eng.max_iter, eng.gap_check_cadence, *lo[1:]), Xr)
        lo_it, lo_ck = res_lo.iters, res_lo.gap_checks
        info = {"gram": False, "lo_iters": lo_it, "lo_checks": lo_ck}
        if res_lo.converged:
            return res_lo, info
        beta0 = res_lo.beta
    res = _fista_solve(eng.backend.fista_step, Xr, eng.y, lam, beta0, L,
                       eng.tol, eng.max_iter, eng.gap_check_cadence)
    return (res._replace(iters=res.iters + lo_it,
                         gap_checks=res.gap_checks + lo_ck),
            {"gram": False, "lo_iters": lo_it, "lo_checks": lo_ck})


def _gram_lo_info(lo_it: int, lo_ck: int, hi: tuple[int, int] | None,
                  n: int, b: int) -> dict:
    """Gram CD's two-phase telemetry: one bf16 G̃ build (``lo_passes``),
    the sweeps at b/n of a pass, 2 passes per check, and on a handover
    (``hi`` = the polish's sweeps and checks) a second, float32 build."""
    if hi is None:
        passes = 1.0 + lo_it * (b / max(n, 1)) + 2.0 * lo_ck
    else:
        passes = (2.0 + (lo_it + hi[0]) * (b / max(n, 1))
                  + 2.0 * (lo_ck + hi[1]))
    return {"gram": True, "lo_iters": lo_it, "lo_checks": lo_ck,
            "lo_passes": 1.0, "x_passes": passes}


def _cd_strategy(eng: "SolverEngine", Xr, lam, beta0, m: int):
    """Gram CD up to the crossover b ≤ min(n, GRAM_BUCKET_MAX), where a
    sweep costs O(b²) against matvec CD's O(n·b); matvec CD above it. On
    a bf16 engine Gram CD runs its bf16 phase first (G̃ from the bf16
    bucket), then rebuilds G in float32 and polishes unless it converged;
    matvec CD has no bf16 phase and records float32."""
    n, b = Xr.shape
    max_epochs = eng.max_iter // 10 + 1
    lo = eng._take_lo()
    sweep = eng.backend.cd_gram_sweep
    if b <= min(n, ops.GRAM_BUCKET_MAX):
        if lo is None:
            return _cd_gram_solve(sweep, Xr, eng.y, lam, beta0, eng.tol,
                                  max_epochs, eng.gap_check_cadence), \
                {"gram": True}
        res_lo = _cd_gram_solve_lo(sweep, Xr, lo[0], eng.y, lam, beta0,
                                   eng.tol, max_epochs,
                                   eng.gap_check_cadence, *lo[1:])
        lo_it, lo_ck = res_lo.iters, res_lo.gap_checks
        if res_lo.converged:
            return res_lo, _gram_lo_info(lo_it, lo_ck, None, n, b)
        res = _cd_gram_solve(sweep, Xr, eng.y, lam, res_lo.beta, eng.tol,
                             max_epochs, eng.gap_check_cadence)
        info = _gram_lo_info(lo_it, lo_ck, (res.iters, res.gap_checks), n,
                             b)
        return res._replace(iters=res.iters + lo_it,
                            gap_checks=res.gap_checks + lo_ck), info
    if lo is not None:
        # past the crossover matvec CD has no certified bf16 stream; a
        # bucket's size is data, not configuration, so no warning
        eng.last_effective_dtype = "float32"
    return _cd_solve(Xr, eng.y, lam, beta0, eng.tol, max_epochs,
                     eng.gap_check_cadence), {"gram": False}


def _group_fista_strategy(eng: "SolverEngine", Xr, lam, beta0, m: int):
    return _group_fista_solve(Xr, eng.y, lam, m, beta0, eng.lipschitz(Xr),
                              eng.tol, eng.max_iter,
                              eng.gap_check_cadence), {"gram": False}


def _fista_strategy_batched(eng: "SolverEngine", Xr, lam, beta0, valid,
                            m: int):
    """The batched twin of :func:`_fista_strategy`: the polish runs only
    if some query has not converged in the bf16 phase, and starts from
    every query's bf16 β (a converged query freezes at once)."""
    L = eng.lipschitz(Xr)
    lo = eng._take_lo()
    res_lo = None
    lo_it = lo_ck = 0
    if lo is not None:
        res_lo = _lo_result(_fista_solve_lo_batched(
            eng.backend.fista_step, Xr, lo[0], eng.y, lam, beta0, valid, L,
            eng.tol, eng.max_iter, eng.gap_check_cadence, *lo[1:]), Xr)
        lo_it, lo_ck = int(np.max(res_lo.iters)), res_lo.gap_checks
        if res_lo.converged.all():
            return res_lo, {"gram": False, "lo_iters": lo_it,
                            "lo_checks": lo_ck, "hi_iters": 0}
        beta0 = res_lo.beta
    res = _fista_solve_batched(eng.backend.fista_step, Xr, eng.y, lam,
                               beta0, valid, L, eng.tol, eng.max_iter,
                               eng.gap_check_cadence)
    hi_it = int(np.max(res.iters))
    if res_lo is not None:
        res = res._replace(iters=res.iters + res_lo.iters,
                           gap_checks=res.gap_checks + lo_ck)
    return res, {"gram": False, "lo_iters": lo_it, "lo_checks": lo_ck,
                 "hi_iters": hi_it}


def _cd_strategy_batched(eng: "SolverEngine", Xr, lam, beta0, valid,
                         m: int):
    """The batched twin of :func:`_cd_strategy`, with the same crossover
    and bf16 phase."""
    n, b = Xr.shape
    max_epochs = eng.max_iter // 10 + 1
    lo = eng._take_lo()
    sweep = eng.backend.cd_gram_sweep
    if b <= min(n, ops.GRAM_BUCKET_MAX):
        if lo is None:
            return _cd_gram_solve_batched(sweep, Xr, eng.y, lam, beta0,
                                          valid, eng.tol, max_epochs,
                                          eng.gap_check_cadence), \
                {"gram": True}
        res_lo = _cd_gram_solve_lo_batched(
            sweep, Xr, lo[0], eng.y, lam, beta0, valid, eng.tol, max_epochs,
            eng.gap_check_cadence, *lo[1:])
        lo_it, lo_ck = int(np.max(res_lo.iters)), res_lo.gap_checks
        if res_lo.converged.all():
            return res_lo, _gram_lo_info(lo_it, lo_ck, None, n, b)
        res = _cd_gram_solve_batched(sweep, Xr, eng.y, lam, res_lo.beta,
                                     valid, eng.tol, max_epochs,
                                     eng.gap_check_cadence)
        info = _gram_lo_info(lo_it, lo_ck,
                             (int(np.max(res.iters)), res.gap_checks), n, b)
        return res._replace(iters=res.iters + res_lo.iters,
                            gap_checks=res.gap_checks + lo_ck), info
    if lo is not None:
        eng.last_effective_dtype = "float32"
    return _cd_solve_batched(Xr, eng.y, lam, beta0, valid, eng.tol,
                             max_epochs, eng.gap_check_cadence), \
        {"gram": False}


SOLVERS: dict[str, Callable] = {
    "fista": _fista_strategy,
    "cd": _cd_strategy,
    "group_fista": _group_fista_strategy,
}

# Batched twins ``(engine, Xr, lam (B,), beta0 (B, b), valid (B, b), m) ->
# (SolveResult, info)``. A strategy without one runs once per query
# (``SolverEngine.solve_batched``).
BATCHED_SOLVERS: dict[str, Callable] = {
    "fista": _fista_strategy_batched,
    "cd": _cd_strategy_batched,
}


#: The strategies that solve the group Lasso: a session fitted with
#: ``groups=m`` takes only these, a plain-Lasso session none of them.
GROUP_SOLVERS = ("group_fista",)


def register_solver(name: str, strategy: Callable,
                    batched: Callable | None = None) -> None:
    """Add a strategy ``(engine, Xr, lam, beta0, m) -> (SolveResult,
    {"gram": bool})``; select it with ``SolveSpec(strategy=name)``.
    ``batched`` serves (B, n) paths natively (see ``BATCHED_SOLVERS``);
    without it a batched solve runs the strategy once per query."""
    SOLVERS[name] = strategy
    if batched is not None:
        BATCHED_SOLVERS[name] = batched
    else:
        BATCHED_SOLVERS.pop(name, None)


def available_solvers() -> tuple[str, ...]:
    return tuple(SOLVERS)


class SolverEngine:
    """One entry point for every reduced solve on a λ-path::

        eng = SolverEngine(y, solver="fista", tol=1e-8, max_iter=5000)
        res = eng.solve(Xr, lam, beta0)

    Telemetry of the last solve: ``last_gap_checks``, ``last_used_gram``,
    ``last_x_passes`` (passes over the reduced buffer, as the reference
    counts them: FISTA 2 per iteration — forward fit and gradient — CD
    one per epoch, Gram CD one to build G plus b/n per sweep, and 2 per gap
    check), ``last_solve_bytes`` (the bf16 phase's iteration passes — or
    Gram CD's one G̃ build — at 2 bytes an element, every other pass at
    Xr's element size; ``total_solve_bytes`` over the engine's solves),
    ``last_lo_iters`` (the bf16 phase's iterations) and
    ``last_effective_dtype`` (the stream the solve read: "bfloat16" where
    a bf16 phase ran). These are the reference's pass and byte models;
    what the port moves in a bf16 FISTA iteration differs (PERF.md §2).
    """

    def __init__(self, y: torch.Tensor, *, solver: str = "fista",
                 backend=None, tol: float = 1e-8, max_iter: int = 5000,
                 gap_check_cadence: int = 10, solve_dtype: str = "float32",
                 power_iters: int = 50, warm_power_iters: int = 16,
                 seed: int = 0, eig_cache: dict | None = None,
                 eig_stats: dict | None = None):
        if solver not in SOLVERS:
            raise ValueError(f"unknown solver {solver!r}; "
                             f"available: {available_solvers()}")
        if solve_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown solve_dtype {solve_dtype!r}; "
                             "expected 'float32' or 'bfloat16'")
        self.y = y
        self.solve_dtype = solve_dtype
        self.solver = solver
        self.backend = ops.resolve_backend(backend, y.device)
        self.tol = tol
        self.max_iter = max_iter
        self.gap_check_cadence = max(1, int(gap_check_cadence))
        self.power_iters = power_iters
        self.warm_power_iters = warm_power_iters
        self.seed = seed
        self._eig_cache: dict[int, torch.Tensor] = (
            eig_cache if eig_cache is not None else {})
        self._eig_stats: dict[str, int] = (
            eig_stats if eig_stats is not None else {"warm": 0, "cold": 0})
        self.last_gap_checks = 0
        self.last_used_gram = False
        self.last_x_passes = 0.0
        self.last_solve_bytes = 0.0
        self.total_solve_bytes = 0.0
        self.last_lo_iters = 0
        self.last_effective_dtype = "float32"
        self._lo = None       # the staged (X̃, err_max, cn_max)

    @property
    def backend_name(self) -> str:
        return self.backend.name

    def lipschitz(self, Xr: torch.Tensor) -> float:
        """1.05·‖X_r‖₂², warm-started from the eigenvector cached for the
        bucket size (a new size starts cold from ``seed``)."""
        bucket = Xr.shape[1]
        v_prev = self._eig_cache.get(bucket)
        if v_prev is None:
            self._eig_stats["cold"] = self._eig_stats.get("cold", 0) + 1
            eig, v = top_eigenpair(Xr, iters=self.power_iters,
                                   seed=self.seed)
        else:
            self._eig_stats["warm"] = self._eig_stats.get("warm", 0) + 1
            eig, v = top_eigenpair(Xr, iters=self.warm_power_iters,
                                   v0=v_prev)
        self._eig_cache[bucket] = v
        if Xr.dtype == torch.float32:   # the reference's float32 product
            return float(_F32(1.05) * _F32(float(eig)))
        return 1.05 * float(eig)

    def _stage_lo(self, Xr: torch.Tensor, lo) -> None:
        """Arm the bf16 phase of the next strategy call (the strategies'
        signature is fixed, so the triple waits on the engine until
        :meth:`_take_lo`). ``lo`` is ``(X̃, col_err, col_norms)``, the
        path's gather from the session's bf16 copy, else made from Xr;
        the phase takes their maxima over the bucket (padding columns are
        zero in both). Only ``fista`` and ``cd`` have a bf16 phase; any
        other strategy warns once and solves in float32."""
        self._lo = None
        self.last_effective_dtype = "float32"
        if self.solve_dtype != "bfloat16":
            return
        if self.solver not in ("fista", "cd"):
            _note_solve_f32_fallback(self.solver)
            return
        if lo is None:
            X_lo = Xr.to(torch.bfloat16)
            lo = (X_lo, ops.bf16_column_err(Xr, X_lo),
                  torch.linalg.vector_norm(Xr.to(torch.float32), dim=0))
        X_lo, col_err, col_norms = lo
        self._lo = (X_lo, torch.amax(col_err), torch.amax(col_norms))
        self.last_effective_dtype = "bfloat16"

    def _take_lo(self):
        lo, self._lo = self._lo, None
        return lo

    def _account(self, n: int, b: int, elem: int, lo_passes: float) -> None:
        """``last_solve_bytes`` from ``last_x_passes``: ``lo_passes`` of
        them at 2 bytes an element, the rest at ``elem``."""
        self.last_solve_bytes = ((self.last_x_passes - lo_passes) * n * b
                                 * elem + lo_passes * n * b * 2.0)
        self.total_solve_bytes += self.last_solve_bytes

    def _passes(self, it: int, ck: int, gram: bool, n: int,
                b: int) -> float:
        if gram:
            return 1.0 + it * (b / max(n, 1)) + 2.0 * ck
        if self.solver == "cd":
            return float(it) + 2.0 * ck
        return 2.0 * it + 2.0 * ck

    def solve_batched(self, Xr: torch.Tensor, lam, beta0=None, valid=None,
                      m: int = 1, lo=None) -> SolveResult:
        """Solve B reduced problems that share the bucket Xr; the engine
        was built with y (B, n). ``lam`` is the per-query λ (B,) (host
        values), ``valid`` (B, b) ∈ {0, 1} the columns each query kept,
        ``lo`` as in :meth:`solve`. Telemetry counts passes over the
        bucket per *batch* (one pass serves every query; each phase's loop
        runs until its last query converges: the bf16 phase's
        2·max(lo iterations) passes at 2 bytes and 2 per check, the
        polish's); the per-query fallback sums its queries' passes."""
        if self.y.dim() != 2:
            raise ValueError("solve_batched needs a batched engine "
                             "(construct SolverEngine with y of shape (B, n))")
        B = self.y.shape[0]
        n, b = Xr.shape
        lam = np.asarray(lam, dtype=np.float64).reshape(-1)
        if lam.shape != (B,):
            raise ValueError(f"lam must be ({B},), got {lam.shape}")
        if beta0 is None:
            beta0 = torch.zeros((B, b), dtype=Xr.dtype, device=Xr.device)
        self._stage_lo(Xr, lo)
        strategy = BATCHED_SOLVERS.get(self.solver)
        lo_it, lo_passes = 0, 0.0
        if strategy is not None:
            res, info = strategy(self, Xr, lam, beta0, valid, m)
            gram = bool(info.get("gram", False))
            self.last_gap_checks = int(res.gap_checks)
            lo_it = int(info.get("lo_iters", 0))
            lo_passes = float(info.get("lo_passes", 2.0 * lo_it))
            if "x_passes" in info:
                self.last_x_passes = float(info["x_passes"])
            else:
                lo_ck = int(info.get("lo_checks", 0))
                hi_it = int(info.get("hi_iters", np.max(res.iters)))
                self.last_x_passes = (
                    self._passes(hi_it, self.last_gap_checks - lo_ck, gram,
                                 n, b) + lo_passes + 2.0 * lo_ck)
        else:
            res, gram = self._solve_each(Xr, lam, beta0, valid, m)
        self.last_used_gram = gram
        self.last_lo_iters = lo_it
        self._account(n, b, Xr.element_size(), lo_passes)
        return res

    def _solve_each(self, Xr, lam, beta0, valid, m: int):
        """The fallback for a strategy without a batched twin: the rank-1
        strategy per query, on the bucket with the columns that query
        screened out zeroed (fixed points), so it solves the query's own
        problem. The eigenvector cached for the bucket's size is dropped
        before each query: one supported on another query's columns may
        lie in this bucket's null space and give eig ≈ 0."""
        parts, checks, gram, passes = [], 0, False, 0.0
        n, b = Xr.shape
        y_full = self.y
        try:
            for q in range(y_full.shape[0]):
                self.y = y_full[q]
                Xq, b0 = Xr, beta0[q]
                if valid is not None:
                    Xq, b0 = Xr * valid[q][None, :], b0 * valid[q]
                self._eig_cache.pop(b, None)
                r, info = SOLVERS[self.solver](self, Xq, float(lam[q]), b0, m)
                parts.append(r)
                checks += int(r.gap_checks)
                g = bool(info.get("gram", False))
                gram = gram or g
                passes += self._passes(int(r.iters), int(r.gap_checks), g,
                                       n, b)
        finally:
            self.y = y_full
        self.last_gap_checks = checks
        self.last_x_passes = passes
        res = SolveResult(
            torch.stack([r.beta for r in parts]),
            np.array([float(r.gap) for r in parts]),
            np.array([int(r.iters) for r in parts]),
            np.array([bool(r.converged) for r in parts]), checks)
        return res, gram

    def solve(self, Xr: torch.Tensor, lam: float, beta0=None, m: int = 1,
              lo=None) -> SolveResult:
        """Solve the reduced problem on the bucket Xr (zero-padded columns
        are fixed points); ``m`` is the group size of a group solve.
        ``lo``: the bucket's ``(X̃, col_err, col_norms)`` bf16 triple for
        a bf16 engine (ignored by a float32 one; made from Xr when
        None)."""
        if beta0 is None:
            beta0 = torch.zeros((Xr.shape[1],), dtype=Xr.dtype,
                                device=Xr.device)
        self._stage_lo(Xr, lo)
        res, info = SOLVERS[self.solver](self, Xr, lam, beta0, m)
        n, b = Xr.shape
        it, ck = res.iters, res.gap_checks
        self.last_gap_checks = ck
        self.last_used_gram = bool(info.get("gram", False))
        if "x_passes" in info:
            self.last_x_passes = float(info["x_passes"])
        else:
            self.last_x_passes = self._passes(it, ck, self.last_used_gram,
                                              n, b)
        self.last_lo_iters = int(info.get("lo_iters", 0))
        self._account(n, b, Xr.element_size(),
                      float(info.get("lo_passes", 2.0 * self.last_lo_iters)))
        return res


# ---------------------------------------------------------------------------
# One-shot solvers (the reference's ``fista``, ``cd`` and ``group_fista``):
# one problem, no path, the same signatures and defaults
# ---------------------------------------------------------------------------

def _one_shot(X, y, beta0, device):
    """X, y and β0 (zeros by default) as tensors on one device: a tensor
    X keeps its own device, host arrays go to ``device`` (None: the
    card)."""
    dev = X.device if isinstance(X, torch.Tensor) and device is None \
        else resolve_device(device)
    Xt = as_tensor(X, dev)
    yt = as_tensor(y, dev, Xt.dtype)
    b0 = (torch.zeros((Xt.shape[1],), dtype=Xt.dtype, device=dev)
          if beta0 is None else as_tensor(beta0, dev, Xt.dtype))
    return Xt, yt, b0


def _default_lipschitz(X: torch.Tensor) -> float:
    """1.05·‖X‖₂² from a cold power iteration (50 steps, seed 0), the
    product rounded in float32 for float32 X, as the reference's."""
    eig = float(top_eigenpair(X)[0])
    if X.dtype == torch.float32:
        return float(_F32(1.05) * _F32(eig))
    return 1.05 * eig


def fista(X, y, lam, beta0=None, *, max_iter: int = 2000, tol: float = 1e-8,
          check_every: int = 10, lipschitz=None, backend=None,
          device=None) -> SolveResult:
    """FISTA for one Lasso problem with duality-gap stopping (relative
    tol: gap ≤ tol·½‖y‖², checked every ``check_every`` iterations).
    Each iteration is one forward fit and one ``fista_step`` launch of
    the solver backend (``cuda`` on the card, the plain version on CPU
    tensors; ``backend=`` names another). ``lipschitz`` defaults to
    1.05·‖X‖₂² by power iteration. X as a tensor keeps its device; host
    arrays go to ``device`` (None: the card)."""
    X, y, b0 = _one_shot(X, y, beta0, device)
    L = _default_lipschitz(X) if lipschitz is None else float(lipschitz)
    step_op = ops.resolve_backend(backend, X.device).fista_step
    return _fista_solve(step_op, X, y, float(lam), b0, L, tol, max_iter,
                        max(1, int(check_every)))


def cd(X, y, lam, beta0=None, *, max_epochs: int = 200, tol: float = 1e-10,
       check_every: int = 1, device=None) -> SolveResult:
    """Cyclic coordinate descent for one Lasso problem, on matvecs with
    the residual carried (the reference's one-shot ``cd``; the Gram
    route is the session's ``cd`` strategy): the gap is checked every
    ``check_every`` epochs. Devices as :func:`fista`."""
    X, y, b0 = _one_shot(X, y, beta0, device)
    return _cd_solve(X, y, float(lam), b0, tol, max_epochs,
                     max(1, int(check_every)))


def group_fista(X, y, lam, m: int, beta0=None, *, max_iter: int = 2000,
                tol: float = 1e-8, check_every: int = 10, lipschitz=None,
                device=None) -> SolveResult:
    """Block FISTA for one group-Lasso problem (contiguous groups of m
    columns), as the ``group_fista`` strategy solves a bucket. Devices
    and ``lipschitz`` as :func:`fista`."""
    X, y, b0 = _one_shot(X, y, beta0, device)
    if X.shape[1] % m:
        raise ValueError(f"p={X.shape[1]} is not divisible by m={m}")
    L = _default_lipschitz(X) if lipschitz is None else float(lipschitz)
    return _group_fista_solve(X, y, float(lam), int(m), b0, L, tol,
                              max_iter, max(1, int(check_every)))
