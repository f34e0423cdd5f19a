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
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..kernels import ops
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
    """One reduced solve: β (on the device) and host-side telemetry."""

    beta: torch.Tensor
    gap: float
    iters: int
    converged: bool
    gap_checks: int = 0


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


# A strategy is ``(engine, Xr, lam, beta0, m) -> (SolveResult, info)``
# with info = {"gram": bool}: whether the solve ran on the Gram system.

def _fista_strategy(eng: "SolverEngine", Xr, lam, beta0, m: int):
    return _fista_solve(eng.backend.fista_step, Xr, eng.y, lam, beta0,
                        eng.lipschitz(Xr), eng.tol, eng.max_iter,
                        eng.gap_check_cadence), {"gram": False}


def _cd_strategy(eng: "SolverEngine", Xr, lam, beta0, m: int):
    """Gram CD up to the crossover b ≤ min(n, GRAM_BUCKET_MAX), where a
    sweep costs O(b²) against matvec CD's O(n·b); matvec CD above it."""
    n, b = Xr.shape
    max_epochs = eng.max_iter // 10 + 1
    if b <= min(n, ops.GRAM_BUCKET_MAX):
        return _cd_gram_solve(eng.backend.cd_gram_sweep, Xr, eng.y, lam,
                              beta0, eng.tol, max_epochs,
                              eng.gap_check_cadence), {"gram": True}
    return _cd_solve(Xr, eng.y, lam, beta0, eng.tol, max_epochs,
                     eng.gap_check_cadence), {"gram": False}


def _group_fista_strategy(eng: "SolverEngine", Xr, lam, beta0, m: int):
    return _group_fista_solve(Xr, eng.y, lam, m, beta0, eng.lipschitz(Xr),
                              eng.tol, eng.max_iter,
                              eng.gap_check_cadence), {"gram": False}


SOLVERS: dict[str, Callable] = {
    "fista": _fista_strategy,
    "cd": _cd_strategy,
    "group_fista": _group_fista_strategy,
}


#: The strategies that solve the group Lasso: a session fitted with
#: ``groups=m`` takes only these, a plain-Lasso session none of them.
GROUP_SOLVERS = ("group_fista",)


def register_solver(name: str, strategy: Callable) -> None:
    """Add a strategy ``(engine, Xr, lam, beta0, m) -> (SolveResult,
    {"gram": bool})``; select it with ``SolveSpec(strategy=name)``."""
    SOLVERS[name] = strategy


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
    check) and ``last_solve_bytes``.
    """

    def __init__(self, y: torch.Tensor, *, solver: str = "fista",
                 backend=None, tol: float = 1e-8, max_iter: int = 5000,
                 gap_check_cadence: int = 10, power_iters: int = 50,
                 warm_power_iters: int = 16, seed: int = 0,
                 eig_cache: dict | None = None,
                 eig_stats: dict | None = None):
        if solver not in SOLVERS:
            raise ValueError(f"unknown solver {solver!r}; "
                             f"available: {available_solvers()}")
        self.y = y
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

    def solve(self, Xr: torch.Tensor, lam: float, beta0=None,
              m: int = 1) -> SolveResult:
        """Solve the reduced problem on the bucket Xr (zero-padded columns
        are fixed points); ``m`` is the group size of a group solve."""
        if beta0 is None:
            beta0 = torch.zeros((Xr.shape[1],), dtype=Xr.dtype,
                                device=Xr.device)
        res, info = SOLVERS[self.solver](self, Xr, lam, beta0, m)
        n, b = Xr.shape
        it, ck = res.iters, res.gap_checks
        self.last_gap_checks = ck
        self.last_used_gram = bool(info.get("gram", False))
        if self.last_used_gram:
            self.last_x_passes = 1.0 + it * (b / max(n, 1)) + 2.0 * ck
        elif self.solver == "cd":
            self.last_x_passes = float(it) + 2.0 * ck
        else:
            self.last_x_passes = 2.0 * it + 2.0 * ck
        self.last_solve_bytes = self.last_x_passes * n * b \
            * Xr.element_size()
        return res
