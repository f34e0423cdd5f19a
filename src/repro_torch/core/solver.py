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
"""

from __future__ import annotations

import functools
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
    """One reduced solve: β (on the device) and host-side telemetry.
    Batched: β (B, b), and gap, iters, converged host (B,) arrays."""

    beta: torch.Tensor
    gap: float | np.ndarray
    iters: int | np.ndarray
    converged: bool | np.ndarray
    gap_checks: int = 0


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
        frozen = bt.frozen()
        for i in range(k, k + cadence):
            beta_new, z_new = step_op(X, z @ X.T - Y, z, beta,
                                      params=table[i])
            if valid is not None:
                beta_new, z_new = beta_new * valid, z_new * valid
            if frozen is not None:
                beta_new = torch.where(frozen, beta, beta_new)
                z_new = torch.where(frozen, z, z_new)
            beta, z = beta_new, z_new
        bt.advance(cadence)
        k += cadence
        bt.check(beta)
    return bt.result(beta)


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


def _fista_strategy_batched(eng: "SolverEngine", Xr, lam, beta0, valid,
                            m: int):
    return _fista_solve_batched(eng.backend.fista_step, Xr, eng.y, lam,
                                beta0, valid, eng.lipschitz(Xr), eng.tol,
                                eng.max_iter, eng.gap_check_cadence), \
        {"gram": False}


def _cd_strategy_batched(eng: "SolverEngine", Xr, lam, beta0, valid,
                         m: int):
    """The batched twin of :func:`_cd_strategy`, with the same crossover."""
    n, b = Xr.shape
    max_epochs = eng.max_iter // 10 + 1
    if b <= min(n, ops.GRAM_BUCKET_MAX):
        return _cd_gram_solve_batched(eng.backend.cd_gram_sweep, Xr, eng.y,
                                      lam, beta0, valid, eng.tol, max_epochs,
                                      eng.gap_check_cadence), {"gram": True}
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

    def _passes(self, it: int, ck: int, gram: bool, n: int,
                b: int) -> float:
        if gram:
            return 1.0 + it * (b / max(n, 1)) + 2.0 * ck
        if self.solver == "cd":
            return float(it) + 2.0 * ck
        return 2.0 * it + 2.0 * ck

    def solve_batched(self, Xr: torch.Tensor, lam, beta0=None, valid=None,
                      m: int = 1) -> SolveResult:
        """Solve B reduced problems that share the bucket Xr; the engine
        was built with y (B, n). ``lam`` is the per-query λ (B,) (host
        values), ``valid`` (B, b) ∈ {0, 1} the columns each query kept.
        Telemetry counts passes over the bucket per *batch* (one pass
        serves every query; a loop runs until its last query converges);
        the per-query fallback sums its queries' passes."""
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
        strategy = BATCHED_SOLVERS.get(self.solver)
        if strategy is not None:
            res, info = strategy(self, Xr, lam, beta0, valid, m)
            gram = bool(info.get("gram", False))
            self.last_gap_checks = int(res.gap_checks)
            self.last_x_passes = self._passes(int(np.max(res.iters)),
                                              self.last_gap_checks, gram,
                                              n, b)
        else:
            res, gram = self._solve_each(Xr, lam, beta0, valid, m)
        self.last_used_gram = gram
        self.last_solve_bytes = self.last_x_passes * n * b \
            * Xr.element_size()
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
        self.last_x_passes = self._passes(it, ck, self.last_used_gram, n, b)
        self.last_solve_bytes = self.last_x_passes * n * b \
            * Xr.element_size()
        return res
