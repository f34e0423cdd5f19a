"""SolverEngine: the reduced solves of the λ-path behind a registry.

Strategies are registered in ``SOLVERS`` (``register_solver``); this slice
of the port carries ``fista``. Each FISTA iteration is one forward fit
``X @ z`` (``torch.matmul``, as the reference left it to XLA) and one
fused ``fista_step`` kernel pass (gradient + prox + momentum).

The reference runs the loop on the device (``lax.while_loop``). Here the
host drives it in blocks of ``gap_check_cadence`` iterations: nothing in
a block waits for the device — the momentum sequence t_k does not depend
on the data, so ``mom`` is a host float (computed in float32, as the
reference computes it) and every kernel argument is passed by value —
and each duality-gap check costs one ``.item()`` sync. The step 1/L
costs one more sync per solve.

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
from .lasso import gap_from_residual, top_eigenpair

_F32 = np.float32


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
    fl = _F32 if X.dtype == torch.float32 else np.float64
    step = float(fl(1.0) / fl(max(lipschitz, 1e-12)))
    thresh = tol * (0.5 * float(torch.sum(y * y)) + 1e-30)

    def gap_of(beta) -> float:
        r = y - X @ beta
        return float(gap_from_residual(r, X.T @ r, beta, lam, y))

    beta, z, t = beta0, beta0, fl(1.0)
    k, gap, checks = 0, gap_of(beta0), 1
    while k < max_iter and gap > thresh:
        for _ in range(cadence):
            rz = X @ z - y
            t_new = fl(0.5) * (fl(1.0) + np.sqrt(fl(1.0) + fl(4.0) * t * t))
            mom = (t - fl(1.0)) / t_new
            beta, z = step_op(X, rz, z, beta, step, lam, float(mom))
            t = t_new
        k += cadence
        gap = gap_of(beta)
        checks += 1
    return SolveResult(beta, gap, k, gap <= thresh, checks)


def _fista_strategy(eng: "SolverEngine", Xr, lam, beta0) -> SolveResult:
    return _fista_solve(eng.backend.fista_step, Xr, eng.y, lam, beta0,
                        eng.lipschitz(Xr), eng.tol, eng.max_iter,
                        eng.gap_check_cadence)


SOLVERS: dict[str, Callable] = {"fista": _fista_strategy}


def register_solver(name: str, strategy: Callable) -> None:
    """Add a strategy ``(engine, Xr, lam, beta0) -> SolveResult``."""
    SOLVERS[name] = strategy


def available_solvers() -> tuple[str, ...]:
    return tuple(SOLVERS)


class SolverEngine:
    """One entry point for every reduced solve on a λ-path::

        eng = SolverEngine(y, solver="fista", tol=1e-8, max_iter=5000)
        res = eng.solve(Xr, lam, beta0)

    Telemetry of the last solve: ``last_gap_checks``, ``last_x_passes``
    (passes over the reduced buffer: 2 per iteration — forward fit and
    fused step — and 2 per gap check) and ``last_solve_bytes``.
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

    def solve(self, Xr: torch.Tensor, lam: float, beta0=None) -> SolveResult:
        """Solve the reduced problem on the bucket Xr (zero-padded columns
        are fixed points)."""
        if beta0 is None:
            beta0 = torch.zeros((Xr.shape[1],), dtype=Xr.dtype,
                                device=Xr.device)
        res = SOLVERS[self.solver](self, Xr, lam, beta0)
        n, b = Xr.shape
        self.last_gap_checks = res.gap_checks
        self.last_x_passes = 2.0 * res.iters + 2.0 * res.gap_checks
        self.last_solve_bytes = self.last_x_passes * n * b \
            * Xr.element_size()
        return res
