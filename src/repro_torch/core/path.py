"""Sequential λ-path driver: screen → reduce → solve → (KKT check) → next.

The sequential rules thread the exact dual point θ*(λ_k) from each
solution into the screen for λ_{k+1}. Per grid step the driver screens
through the :class:`~.engine.ScreeningEngine` (one pass over X), gathers
the surviving columns into a power-of-two **bucket** (zero-filled; zero
columns are exact fixed points of the solver), warm-starts β from the
previous step, solves through the :class:`~.solver.SolverEngine`, and
computes the fitted values X_r·β_r from the reduced bucket for the next
dual state. Pow-2 buckets keep the set of bucket sizes, and so the
solver's Lipschitz cache entries, O(log p).

The unit size ``m`` is 1 for the Lasso (units are features) and the
group size for the group Lasso (units are groups: whole groups are
gathered, buckets count groups, masks and ``n_discarded`` are per group).

The bucket comes from a ``columns`` callable. On a mesh session it is
the geometry's (:meth:`.engine.DictionaryGeometry.columns`): X is the
rank's column block of the global X, every rank contributes its kept
columns, and one all-gather puts them in the order of the unsharded
gather, replicated. Every rank then solves the same bucket with the
tile kernels, and the fitted values X_r·β_r (not a psum-ordered X·β) feed
the next dual state, so the masks and β do not depend on the mesh's
shape (the reference's ``reshard``, ``src/repro/core/path.py``).

``batch=B`` drives B queries against one fitted dictionary (the
reference's batched driver): per-query (B, K) grids; per step one
screen for the whole batch (a query whose λ ≥ its own λ_max — its
trivial region — keeps nothing and stays at β = 0); the survivors of
every query gathered into one **union bucket**, each query solving only
its own columns of it (a (B, bucket) validity mask), in one batched
solve; per-query KKT rounds; and ``fitted = β·X_rᵀ`` (B, n) for the next
batched state. The KKT loop runs when the rule is heuristic (group
``strong``) or ``paranoid=True`` asks for it (safe rules never trigger
it).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@dataclasses.dataclass
class PathStepStats:
    lam: float
    n_discarded: int
    n_kept: int
    solver_iters: int
    gap: float
    kkt_rounds: int
    screen_time_s: float
    solve_time_s: float
    x_passes: int = 0             # full HBM passes over X this screen took
    gap_checks: int = 0           # duality-gap evaluations of this step
    gram_step_frac: float = 0.0   # fraction of this step's solves on Gram CD
    solver_backend: str = ""
    screen_backend: str = ""
    bucket: int = 0               # padded bucket size (columns) solved at
    solver_x_passes: float = 0.0  # solver passes in full-X equivalents
    batch_size: int = 1
    queries_converged: int = 0
    x_passes_per_query: float = 0.0
    screen_bytes: float = 0.0     # HBM bytes this step's screens streamed
    screen_dtype_effective: str = ""
    solve_dtype_effective: str = ""
    solver_lo_iters: int = 0
    solve_bytes: float = 0.0      # HBM bytes this step's solves streamed
    geometry_version: int = 0


@dataclasses.dataclass
class PathResult:
    """The path result, with a leading batch axis as in the reference:

        lambdas  (B, K)        λ grids
        betas    (B, K, p)     coefficient paths (float64)
        masks    (B, K, p)     post-KKT discard masks
        stats    [PathStepStats] per grid step
        query_converged (B,)   True iff every non-trivial solve converged

    ``squeeze()`` drops the axis of a B = 1 result.
    """

    lambdas: np.ndarray
    betas: np.ndarray
    stats: list[PathStepStats]
    masks: np.ndarray | None = None
    query_converged: np.ndarray | None = None

    @property
    def batched(self) -> bool:
        return self.betas.ndim == 3

    @property
    def batch(self) -> int:
        return self.betas.shape[0] if self.batched else 1

    @property
    def total_solve_time(self) -> float:
        return sum(s.solve_time_s for s in self.stats)

    @property
    def total_screen_time(self) -> float:
        return sum(s.screen_time_s for s in self.stats)

    def squeeze(self) -> "PathResult":
        if not self.batched:
            return self
        if self.batch != 1:
            raise ValueError(f"squeeze() needs a single-query result, got "
                             f"B={self.batch}; use query(b) to select one "
                             f"query")
        return PathResult(lambdas=self.lambdas[0], betas=self.betas[0],
                          stats=self.stats, masks=self.masks[0],
                          query_converged=self.query_converged)

    def query(self, b: int) -> "PathResult":
        """Query b in the squeezed layout (the stats stay shared;
        ``query_converged`` narrows to query b's flag)."""
        if not self.batched:
            raise ValueError("query(b) needs a batched result")
        qc = self.query_converged
        return PathResult(lambdas=self.lambdas[b], betas=self.betas[b],
                          stats=self.stats, masks=self.masks[b],
                          query_converged=None if qc is None else qc[b:b + 1])


def _gather_cols(X: torch.Tensor, cols: np.ndarray,
                 width: int) -> torch.Tensor:
    """The bucket: columns ``cols`` (host indices) of X, zero-padded to
    ``width`` columns."""
    out = torch.zeros((X.shape[0], width), dtype=X.dtype, device=X.device)
    out[:, :cols.size] = X[:, cols]
    return out


def _pad_indices(kept: np.ndarray, bucket: int, device, dtype):
    idx = np.zeros((bucket,), dtype=np.int64)
    idx[:kept.size] = kept
    valid = np.zeros((bucket,), dtype=np.float32)
    valid[:kept.size] = 1.0
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(valid).to(device=device, dtype=dtype))


def lambda_grid(lam_max: float, num: int = 100, lo_frac: float = 0.05,
                hi_frac: float = 1.0) -> np.ndarray:
    """The paper's grid: ``num`` values equally spaced in λ/λ_max."""
    return np.linspace(hi_frac, lo_frac, num) * lam_max


def _path_driver(X: torch.Tensor, y: torch.Tensor, lambdas, cfg, *,
                 m: int = 1, screen_engine, solver_engine, need_kkt: bool,
                 kkt_fn, columns=None, batch: int | None = None
                 ) -> PathResult:
    """The screen → reduce → solve → KKT loop over a decreasing grid, for
    one query (``batch=None``) or a batch of B (y (B, n), lambdas (B, K);
    :func:`_batched_driver`), over units of ``m`` columns.
    ``kkt_fn(beta_full, lam, discard, fitted)`` flags KKT violations among
    the discarded units. The path's width p is the screen engine's.
    ``columns(cols, width)`` returns the (n, width) bucket of the global
    columns ``cols`` (host indices), zero-padded; by default they are
    gathered from X."""
    p = screen_engine.p
    if columns is None:
        def columns(cols, width):
            return _gather_cols(X, cols, width)
    units = p // m
    if units * m != p:
        raise ValueError(f"p={p} is not divisible by the unit size m={m}")
    bucket_min = cfg.bucket_min if cfg.bucket_min is not None \
        else (32 if m == 1 else 16)
    if batch is not None:
        return _batched_driver(X, y, lambdas, cfg, m=m, units=units,
                               bucket_min=bucket_min,
                               screen_engine=screen_engine,
                               solver_engine=solver_engine,
                               need_kkt=need_kkt, kkt_fn=kkt_fn,
                               columns=columns)
    lambdas = np.asarray(lambdas, dtype=np.float64)
    # written so that a NaN grid (a NaN query's λ_max) fails, as the
    # reference's assertion does
    if lambdas.ndim != 1 or not np.all(np.diff(lambdas) <= 1e-12):
        raise ValueError("lambdas must be a decreasing (K,) grid")
    K = lambdas.shape[0]
    lmax = float(screen_engine.lam_max)
    state = screen_engine.state_at_lambda_max()

    arange_m = np.arange(m)[None, :]
    betas = np.zeros((1, K, p), dtype=np.float64)
    masks = np.ones((1, K, units), dtype=bool)
    stats: list[PathStepStats] = []
    beta_prev = torch.zeros((p,), dtype=X.dtype, device=X.device)
    converged = True

    for k in range(K):
        lam = float(lambdas[k])
        if not lam < lmax:            # β* = 0 in the trivial region (eq. 8)
            stats.append(PathStepStats(lam, units, 0, 0, 0.0, 0, 0.0, 0.0,
                                       queries_converged=1))
            if cfg.checkpoint_fn:
                cfg.checkpoint_fn(k, lam, np.zeros((p,)))
            continue

        # ---- screen: one streaming pass over X ------------------------
        t0 = time.perf_counter()
        discard = screen_engine.screen(lam, state, rule=cfg.rule)
        discard_np = discard.cpu().numpy()
        screen_time = time.perf_counter() - t0

        # ---- reduced solve (+ KKT rounds) -----------------------------
        t0 = time.perf_counter()
        kkt_rounds = gap_checks = solves = gram_solves = 0
        solver_x_passes = solve_bytes = 0.0
        while True:
            kept = np.flatnonzero(~discard_np)
            bucket = min(next_pow2(max(kept.size, bucket_min)), units)
            if kept.size == 0:
                beta_full = torch.zeros((p,), dtype=X.dtype, device=X.device)
                fitted = torch.zeros_like(y)
                iters, gap, conv = 0, 0.0, True
            else:
                col_idx = (kept[:, None] * m + arange_m).reshape(-1)
                idx, valid = _pad_indices(col_idx, bucket * m, X.device,
                                          X.dtype)
                Xr = columns(col_idx, bucket * m)
                beta0 = beta_prev.index_select(0, idx) * valid
                res = solver_engine.solve(Xr, lam, beta0, m=m)
                beta_full = torch.zeros((p,), dtype=X.dtype, device=X.device)
                beta_full[idx[:col_idx.size]] = res.beta[:col_idx.size]
                iters, gap, conv = res.iters, res.gap, res.converged
                # fitted values from the reduced bucket feed the next state
                fitted = Xr @ res.beta
                solves += 1
                gram_solves += int(solver_engine.last_used_gram)
                gap_checks += solver_engine.last_gap_checks
                solver_x_passes += (solver_engine.last_x_passes
                                    * bucket * m / p)
                solve_bytes += solver_engine.last_solve_bytes
            if not need_kkt:
                break
            viol = kkt_fn(beta_full, lam, torch.from_numpy(discard_np)
                          .to(X.device), fitted).cpu().numpy()
            if not viol.any() or kkt_rounds >= cfg.max_kkt_rounds:
                break
            kkt_rounds += 1
            discard_np = discard_np & ~viol
        solve_time = time.perf_counter() - t0

        betas[0, k] = beta_full.cpu().numpy()
        masks[0, k] = discard_np
        converged &= bool(conv)
        stats.append(PathStepStats(
            lam=lam, n_discarded=int(discard_np.sum()), n_kept=int(kept.size),
            solver_iters=int(iters), gap=float(gap), kkt_rounds=kkt_rounds,
            screen_time_s=screen_time, solve_time_s=solve_time,
            x_passes=screen_engine.last_x_passes, gap_checks=gap_checks,
            gram_step_frac=gram_solves / solves if solves else 0.0,
            solver_backend=solver_engine.backend_name,
            screen_backend=screen_engine.backend_name, bucket=bucket * m,
            solver_x_passes=solver_x_passes,
            queries_converged=int(bool(conv)),
            x_passes_per_query=float(screen_engine.last_x_passes),
            screen_bytes=screen_engine.last_screen_bytes,
            screen_dtype_effective="float32",
            solve_dtype_effective="float32", solve_bytes=solve_bytes))
        if cfg.checkpoint_fn:
            cfg.checkpoint_fn(k, lam, betas[0, k])

        beta_prev = beta_full
        if cfg.sequential:
            state = screen_engine.make_state(beta_full, lam, fitted=fitted)
        # basic variants keep `state` pinned at λ_max (paper §4.1.1)
    return PathResult(lambdas=lambdas[None, :], betas=betas, stats=stats,
                      masks=masks, query_converged=np.array([converged]))


def _batched_driver(X: torch.Tensor, Y: torch.Tensor, lambdas, cfg, *,
                    m: int, units: int, bucket_min: int, screen_engine,
                    solver_engine, need_kkt: bool, kkt_fn,
                    columns) -> PathResult:
    """:func:`_path_driver` for B queries (the reference's ``batch=B``
    branch, ``src/repro/core/path.py``): one screen a step for the batch,
    the union bucket with per-query validity, one batched solve, per-query
    KKT rounds, the trivial region per query."""
    B, p = Y.shape[0], screen_engine.p
    dev = X.device
    lambdas = np.asarray(lambdas, dtype=np.float64)
    if lambdas.ndim != 2 or lambdas.shape[0] != B \
            or not np.all(np.diff(lambdas, axis=1) <= 1e-12):
        raise ValueError(f"lambdas must be decreasing (B, K) grids with "
                         f"B={B}, got shape {lambdas.shape}")
    K = lambdas.shape[1]
    lmax = np.asarray(screen_engine.lam_max, dtype=np.float64)
    state = screen_engine.state_at_lambda_max()

    arange_m = np.arange(m)[None, :]
    betas = np.zeros((B, K, p), dtype=np.float64)
    masks = np.ones((B, K, units), dtype=bool)
    stats: list[PathStepStats] = []
    beta_prev = torch.zeros((B, p), dtype=X.dtype, device=dev)
    q_converged = np.ones((B,), dtype=bool)

    for k in range(K):
        lam_vec = lambdas[:, k]
        live = lam_vec < lmax          # per-query trivial region (eq. 8)
        if not live.any():             # β* = 0 for the whole batch
            stats.append(PathStepStats(float(lam_vec.max()), units, 0, 0,
                                       0.0, 0, 0.0, 0.0, batch_size=B,
                                       queries_converged=B))
            if cfg.checkpoint_fn:
                cfg.checkpoint_fn(k, lam_vec, np.zeros((B, p)))
            continue

        # ---- screen: one streaming pass over X for the batch ----------
        t0 = time.perf_counter()
        discard = screen_engine.screen(lam_vec, state, rule=cfg.rule)
        discard_np = discard.cpu().numpy() | ~live[:, None]
        screen_time = time.perf_counter() - t0
        screen_passes = screen_engine.last_x_passes

        # ---- one batched solve on the union bucket (+ KKT rounds) ------
        t0 = time.perf_counter()
        kkt_rounds = gap_checks = solves = gram_solves = 0
        solver_x_passes = solve_bytes = 0.0
        while True:
            kept = np.flatnonzero((~discard_np).any(axis=0))
            bucket = min(next_pow2(max(kept.size, bucket_min)), units)
            if kept.size == 0:
                beta_full = torch.zeros((B, p), dtype=X.dtype, device=dev)
                fitted = torch.zeros_like(Y)
                iters, gap, q_conv = 0, 0.0, B
                conv_vec = np.ones((B,), dtype=bool)
            else:
                col_idx = (kept[:, None] * m + arange_m).reshape(-1)
                idx, _ = _pad_indices(col_idx, bucket * m, dev, X.dtype)
                vq_np = np.zeros((B, bucket * m), dtype=np.float32)
                vq_np[:, :col_idx.size] = np.repeat(~discard_np[:, kept], m,
                                                    axis=1)
                vq = torch.from_numpy(vq_np).to(device=dev, dtype=X.dtype)
                Xr = columns(col_idx, bucket * m)
                beta0 = beta_prev.index_select(1, idx) * vq
                res = solver_engine.solve_batched(Xr, lam_vec, beta0,
                                                  valid=vq, m=m)
                beta_full = torch.zeros((B, p), dtype=X.dtype, device=dev)
                beta_full[:, idx[:col_idx.size]] = res.beta[:, :col_idx.size]
                iters, gap = int(np.max(res.iters)), float(np.max(res.gap))
                conv_vec = np.asarray(res.converged, dtype=bool)
                q_conv = int(conv_vec.sum())
                # fitted values from the reduced bucket feed the next state
                fitted = res.beta @ Xr.T
                solves += 1
                gram_solves += int(solver_engine.last_used_gram)
                gap_checks += solver_engine.last_gap_checks
                solver_x_passes += (solver_engine.last_x_passes
                                    * bucket * m / p)
                solve_bytes += solver_engine.last_solve_bytes
            if not need_kkt:
                break
            viol = kkt_fn(beta_full, lam_vec,
                          torch.from_numpy(discard_np).to(dev),
                          fitted).cpu().numpy() & live[:, None]
            if not viol.any() or kkt_rounds >= cfg.max_kkt_rounds:
                break
            kkt_rounds += 1
            discard_np = discard_np & ~viol
        solve_time = time.perf_counter() - t0

        betas[:, k] = beta_full.cpu().numpy()
        masks[:, k] = discard_np
        # a query in its trivial region is vacuously converged
        q_converged &= conv_vec | ~live
        stats.append(PathStepStats(
            lam=float(lam_vec.max()),
            n_discarded=int(discard_np.all(axis=0).sum()),
            n_kept=int(kept.size), solver_iters=iters, gap=gap,
            kkt_rounds=kkt_rounds, screen_time_s=screen_time,
            solve_time_s=solve_time, x_passes=screen_passes,
            gap_checks=gap_checks,
            gram_step_frac=gram_solves / solves if solves else 0.0,
            solver_backend=solver_engine.backend_name,
            screen_backend=screen_engine.backend_name, bucket=bucket * m,
            solver_x_passes=solver_x_passes, batch_size=B,
            queries_converged=q_conv,
            x_passes_per_query=screen_passes / B,
            screen_bytes=screen_engine.last_screen_bytes,
            screen_dtype_effective="float32",
            solve_dtype_effective="float32", solve_bytes=solve_bytes))
        if cfg.checkpoint_fn:
            cfg.checkpoint_fn(k, lam_vec, betas[:, k])

        beta_prev = beta_full
        if cfg.sequential:
            state = screen_engine.make_state(beta_full, lam_vec,
                                             fitted=fitted)
    return PathResult(lambdas=lambdas, betas=betas, stats=stats,
                      masks=masks, query_converged=q_converged)
