"""The mixed-precision solve (``solve_dtype="bfloat16"``) on the CPU, in
the port (``repro_torch``) against the reference (``repro``) on the same
numpy inputs.

The contract, per test:

* ``fista_step`` on the bf16 copy of X (r, z, β_old float32): the port's
  plain version against the reference's Pallas kernel in interpret mode
  and its jnp oracle, at ``tests/test_kernels.py``'s shapes, with the
  float32 row's tolerance (both widen X exactly, so only the order of
  the float32 sums differs); the CUDA wrapper routes bf16 X to its own
  entry point (``fista_step_bf16``, launch or raise, never the plain
  version) and refuses any other dtype;
* ``bf16_gap_budget`` and ``bf16_certified_stop``: the reference's bits
  in float32, on scalars and (B,) vectors, with ``prev_gap = inf``;
* ``SolverEngine(y, solve_dtype="bfloat16")``: ``fista`` and Gram
  ``cd`` give the reference engine's iterations, gap checks, bf16-phase
  iterations, passes and bytes (the same start vector, the same
  arithmetic), β within ``beta_err_tol``; matvec ``cd`` past the Gram
  crossover records float32; the batched twins at B = 4 freeze each
  query on its own;
* ``LassoSession.path`` with ``SolveSpec(solve_dtype="bfloat16")``, one
  query and a batch of 4, fista and cd, against the reference's session:
  masks equal outside BAND of the EDPP threshold (counted), β within
  ``beta_err_tol``, ``solve_dtype_effective`` equal step by step and
  ``solver_lo_iters > 0`` on the same steps;
* a group session solves in float32 with one ``RuntimeWarning``; the mesh
  refusal is in ``tests/test_torch_session.py``.
"""

import ctypes
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LassoSession as JSession
from repro.core import PathConfig as JConfig
from repro.core import SolverEngine as JSolver
from repro.core import SolveSpec as JSolve
from repro.data.pipeline import group_lasso_problem, lasso_problem
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
from repro_torch.core import solver as tsolver
from repro_torch.core.solver import SolverEngine
from repro_torch.kernels import build, edpp_screen, ops, ref, solver_step
from test_torch_batched import _reference_scores
from test_torch_kernels import _CudaLike, no_toolkit  # noqa: F401

SHAPES = [(8, 128), (60, 300), (128, 512), (100, 1000), (7, 130), (256, 131)]
TOL = dict(rtol=2e-5, atol=2e-5)
BAND = 1e-4
SOLVE_TOL = 1e-6


def beta_err_tol(y, solver_tol, kappa=25.0):
    """benchmarks/common.py: two gap-ε solutions differ by ≤ this."""
    y = np.asarray(y, np.float64)
    return kappa * float(np.sqrt(solver_tol * 0.5 * float(y @ y)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(port, *refs):
    for r in refs:
        np.testing.assert_allclose(np.asarray(port, np.float32),
                                   np.asarray(r, np.float32), **TOL)


# ---------------------------------------------------------------------------
# fista_step on bf16 X
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_fista_step_on_bf16_x_matches_reference_kernel(shape, batch):
    n, p = shape
    rng = np.random.default_rng(hash(shape) % 2**31 + batch)
    lead = () if batch == 1 else (batch,)
    X = rng.standard_normal((n, p)).astype(np.float32)
    r, z, b = (rng.standard_normal(lead + (k,)).astype(np.float32)
               for k in (n, p, p))
    lam = (2.5 if batch == 1
           else rng.uniform(0.5, 3.0, batch).astype(np.float32))
    Xb = _t(X).to(torch.bfloat16)
    Xj = jnp.asarray(X).astype(jnp.bfloat16)
    # the same bf16 copy: both round to nearest even
    np.testing.assert_array_equal(Xb.float().numpy(),
                                  np.asarray(Xj.astype(jnp.float32)))
    out = ref.fista_step_ref(Xb, _t(r), _t(z), _t(b), 0.01,
                             torch.as_tensor(lam), 0.6)
    assert all(o.dtype == torch.float32 and o.shape == lead + (p,)
               for o in out)
    args = (Xj, jnp.asarray(r), jnp.asarray(z), jnp.asarray(b), 0.01,
            jnp.asarray(lam), 0.6)
    for o, o_j in zip(out, jref.fista_step_ref(*args)):
        _close(o, o_j)
    if batch == 1 or shape == (60, 300):
        for o, o_k in zip(out, jops.fista_step(*args, interpret=True)):
            _close(o, o_k)
    # the widened copy gives the same numbers: the gradient reads X̃ exactly
    wide = ref.fista_step_ref(Xb.float(), _t(r), _t(z), _t(b), 0.01,
                              torch.as_tensor(lam), 0.6)
    for o, w in zip(out, wide):
        assert torch.equal(o, w)


def test_fista_step_wrapper_routes_bf16_x(no_toolkit):  # noqa: F811
    """CPU bf16 X: the plain version. A CUDA bf16 X goes to its own
    entry point (here: the build raises, no plain version is called);
    another dtype raises ``TypeError``."""
    rng = np.random.default_rng(4)
    X = _t(rng.standard_normal((40, 96)).astype(np.float32))
    r, z, b = (_t(rng.standard_normal(k).astype(np.float32))
               for k in (40, 96, 96))
    ops.reset_counts()
    got = solver_step.fista_step(X.to(torch.bfloat16), r, z, b, 0.01, 0.5,
                                 0.6)
    want = ref.fista_step_ref(X.to(torch.bfloat16), r, z, b, 0.01, 0.5, 0.6)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.plain_counts()["fista_step"] == 2
    ops.reset_counts()
    Xc, rc = _CudaLike(40, 96, dtype=torch.bfloat16), _CudaLike(40)
    zc = _CudaLike(96)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        solver_step.fista_step(Xc, rc, zc, zc, 0.01, 0.5, 0.6)
    with pytest.raises(TypeError, match="float32 or bfloat16 X"):
        solver_step.fista_step(_CudaLike(40, 96, dtype=torch.float16), rc,
                               zc, zc, 0.01, 0.5, 0.6)
    with pytest.raises(TypeError, match="r must be float32"):
        solver_step.fista_step(Xc, _CudaLike(40, dtype=torch.bfloat16), zc,
                               zc, 0.01, 0.5, 0.6)
    assert sum(ops.plain_counts().values()) == 0
    assert sum(ops.launch_counts().values()) == 0


def test_fista_step_bf16_gets_its_c_signature(monkeypatch):
    """The bf16 entry point crosses ctypes as the float one does: X, r, z
    and β_old as c_void_p, the plan's four ints after B, step | λ | mom as
    c_float, the stream last."""
    libc = ctypes.CDLL(None)
    fn = libc.labs
    monkeypatch.setattr(build, "load", lambda source: types.SimpleNamespace(
        fista_step_bf16=fn))
    got = edpp_screen.kernel_fn("solver_step", "fista_step_bf16")
    assert got is fn and fn.restype is ctypes.c_int
    assert fn.argtypes == edpp_screen._SIGNATURES["fista_step_f32"]
    assert len(fn.argtypes) == 18 and fn.argtypes[-1] is ctypes.c_void_p


def test_launch_counts_list_the_bf16_instantiations_once_launched():
    ops.reset_counts()
    assert "fista_step_bf16" not in ops.launch_counts()
    ops.add_counts({"fista_step_bf16": 3, "screen_matvec_bf16": 2}, {})
    counts = ops.launch_counts()
    assert counts["fista_step_bf16"] == 3 and counts["fista_step"] == 0
    assert counts["screen_matvec_bf16"] == 2
    ops.add_counts({"fista_step_bf16": 3}, {}, times=-1)
    assert ops.launch_counts()["fista_step_bf16"] == 0
    ops.reset_counts()


# ---------------------------------------------------------------------------
# the handover rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [None, 5])
def test_gap_budget_and_certified_stop_match_reference(batch):
    rng = np.random.default_rng(11)
    shape = () if batch is None else (batch,)
    f32 = np.float32
    rn = rng.uniform(0.1, 10.0, shape).astype(f32)
    l1 = rng.uniform(0.0, 5.0, shape).astype(f32)
    err, cn = f32(3e-3), f32(7.5)
    budget = ops.bf16_gap_budget(_t(rn), _t(l1), torch.tensor(err),
                                 torch.tensor(cn))
    budget_j = jops.bf16_gap_budget(jnp.asarray(rn), jnp.asarray(l1),
                                    jnp.asarray(err), jnp.asarray(cn))
    assert budget.dtype == torch.float32
    np.testing.assert_array_equal(budget.numpy(), np.asarray(budget_j))
    assert (ops.BF16_SOLVE_SLACK, ops.BF16_SOLVE_PROGRESS) == (
        jops.BF16_SOLVE_SLACK, jops.BF16_SOLVE_PROGRESS)
    b = budget.numpy()
    # gaps on both sides of each test: converged, stalled and floored,
    # stalled above the floor, still falling inside it
    cases = [(0.5 * b, b), (1.9 * b, 2.0 * b), (2.1 * b, 2.2 * b),
             (1.0 * b, 10.0 * b), (np.full(shape, 1e-9, f32), 1e9 * b)]
    for gap, prev in cases:
        gap = np.asarray(gap, f32)
        for prev_gap in (np.asarray(prev, f32), np.full(shape, np.inf, f32)):
            thr = np.asarray(0.25 * b, f32)
            got = ops.bf16_certified_stop(_t(gap), budget, _t(prev_gap),
                                          _t(thr))
            want = jops.bf16_certified_stop(
                jnp.asarray(gap), jnp.asarray(b), jnp.asarray(prev_gap),
                jnp.asarray(thr))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _problem(n, p, seed, nnz=6):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(np.float32)
    w = np.zeros(p)
    w[rng.choice(p, nnz, replace=False)] = rng.uniform(-1, 1, nnz)
    y = (X @ w + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return X, y


def _engines(y, p, solver, seed=7, **kw):
    v0 = np.random.default_rng(seed).standard_normal(p).astype(np.float32)
    port = SolverEngine(_t(y), solver=solver, tol=SOLVE_TOL,
                        solve_dtype="bfloat16", eig_cache={p: _t(v0)}, **kw)
    refe = JSolver(jnp.asarray(y), solver=solver, backend="jnp",
                   tol=SOLVE_TOL, solve_dtype="bfloat16",
                   eig_cache={p: jnp.asarray(v0)}, **kw)
    return port, refe


def _same_telemetry(port, refe):
    assert port.last_lo_iters == refe.last_lo_iters
    assert port.last_x_passes == refe.last_x_passes
    assert port.last_solve_bytes == refe.last_solve_bytes
    assert port.last_effective_dtype == refe.last_effective_dtype
    assert port.last_used_gram == refe.last_used_gram


@pytest.mark.parametrize("frac", [0.7, 0.3, 0.1])
@pytest.mark.parametrize("solver, n, p", [("fista", 50, 64),
                                          ("cd", 80, 64),
                                          ("cd", 50, 64)])
def test_engine_bf16_solve_matches_reference_engine(solver, n, p, frac):
    """fista, Gram cd (p ≤ n) and matvec cd (p > n: float32, recorded) on
    one bucket, from the same start vector: the reference's counts."""
    X, y = _problem(n, p, seed=6)
    lam = frac * float(np.abs(X.T @ y).max())
    port, refe = _engines(y, p, solver)
    res = port.solve(_t(X), lam)
    res_j = refe.solve(jnp.asarray(X), lam)
    assert res.converged and bool(res_j.converged)
    assert res.iters == int(res_j.iters)
    assert res.gap_checks == int(res_j.gap_checks) == port.last_gap_checks
    _same_telemetry(port, refe)
    gram = solver == "cd" and p <= n
    assert port.last_effective_dtype == ("bfloat16" if solver == "fista"
                                         or gram else "float32")
    assert port.last_used_gram == gram
    lo, it, ck = port.last_lo_iters, res.iters, res.gap_checks
    nb = n * p
    if solver == "fista":
        assert lo > 0
        assert port.last_x_passes == 2 * it + 2 * ck
        assert port.last_solve_bytes == ((2 * it + 2 * ck - 2 * lo) * nb * 4
                                         + 2 * lo * nb * 2)
    elif gram:
        assert lo > 0 and lo <= it
        hi = it - lo
        want = (1.0 + lo * p / n + 2.0 * ck if hi == 0
                else 2.0 + it * p / n + 2.0 * ck)
        assert port.last_x_passes == want
        assert port.last_solve_bytes == (want - 1.0) * nb * 4 + nb * 2
    else:
        assert lo == 0 and port.last_solve_bytes == port.last_x_passes \
            * nb * 4
    err = float(np.abs(res.beta.numpy() - np.asarray(res_j.beta)).max())
    assert err <= beta_err_tol(y, SOLVE_TOL)
    assert port.total_solve_bytes == port.last_solve_bytes


def test_engine_takes_the_gathered_triple_as_it_would_make_it():
    """``lo`` from a gather (the session's route) and ``lo=None`` (made
    from Xr) give the same bits; a float32 engine ignores ``lo``."""
    X, y = _problem(50, 64, seed=8)
    lam = 0.3 * float(np.abs(X.T @ y).max())
    Xt = _t(X)
    X_lo = Xt.to(torch.bfloat16)
    lo = (X_lo, ops.bf16_column_err(Xt, X_lo),
          torch.linalg.vector_norm(Xt, dim=0))
    outs = []
    for arg in (None, lo):
        eng, _ = _engines(y, 64, "fista")
        outs.append((eng.solve(Xt, lam, lo=arg), eng.last_lo_iters))
    assert torch.equal(outs[0][0].beta, outs[1][0].beta)
    assert outs[0][1] == outs[1][1] > 0
    f32 = SolverEngine(_t(y), tol=SOLVE_TOL)
    f32.solve(Xt, lam, lo=lo)
    assert f32.last_effective_dtype == "float32" and f32.last_lo_iters == 0
    assert f32.last_solve_bytes == f32.last_x_passes * 50 * 64 * 4


@pytest.mark.parametrize("solver, n", [("fista", 60), ("cd", 80)])
def test_batched_engine_bf16_solve_matches_reference(solver, n):
    """B = 4 on one bucket, one query with 8 columns screened out and
    one at 1.2·λ_max (β = 0 is its solution: frozen at the first check):
    each query's iterations, the batch's checks, passes and bytes are the
    reference's; the screened-out columns stay 0 and every query is
    within beta_err_tol of the reference's."""
    p, B = 64, 4
    X, _ = _problem(n, p, seed=9)
    rng = np.random.default_rng(10)
    Y = np.stack([X @ np.where(rng.random(p) < 0.1,
                               rng.uniform(-1, 1, p), 0.0)
                  + 0.1 * rng.standard_normal(n)
                  for _ in range(B)]).astype(np.float32)
    lam = np.array([f * float(np.abs(X.T @ Y[b]).max())
                    for b, f in enumerate((0.7, 0.3, 1.2, 0.1))])
    valid = np.ones((B, p), np.float32)
    valid[1, :8] = 0.0
    port, refe = _engines(Y, p, solver, max_iter=400)
    res = port.solve_batched(_t(X), lam, valid=_t(valid))
    res_j = refe.solve_batched(jnp.asarray(X), jnp.asarray(lam, jnp.float32),
                               valid=jnp.asarray(valid))
    np.testing.assert_array_equal(res.iters, np.asarray(res_j.iters))
    np.testing.assert_array_equal(res.converged, np.asarray(res_j.converged))
    assert res.gap_checks == int(res_j.gap_checks)
    _same_telemetry(port, refe)
    assert port.last_effective_dtype == "bfloat16" and port.last_lo_iters > 0
    assert res.iters[2] == 0 and not res.beta[2].any()   # frozen at once
    assert res.iters.max() > 0
    assert not res.beta[1, :8].any()
    for b in range(B):
        err = float(np.abs(res.beta[b].numpy()
                           - np.asarray(res_j.beta[b])).max())
        assert err <= beta_err_tol(Y[b], SOLVE_TOL), b


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

def _batch(X, seed, B=4):
    """A (B, n) batch of responses of 8-sparse truths on X."""
    rng = np.random.default_rng(seed)
    n, p = X.shape
    Y = np.empty((B, n), np.float32)
    for b in range(B):
        w = np.zeros(p)
        idx = rng.choice(p, 8, replace=False)
        w[idx] = rng.uniform(-1.0, 1.0, 8)
        Y[b] = X @ w + 0.1 * rng.standard_normal(n)
    return Y


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("strategy", ["fista", "cd"])
def test_bf16_solve_session_matches_reference_session(strategy, batched):
    """At 80 × 300 the buckets of 32 and 64 columns are on cd's Gram
    side (a bf16 phase), those of 128 on matvec CD (float32, recorded).
    Masks outside BAND of the EDPP threshold (the reference's scores from
    its own previous solutions), β, the effective dtype and where the
    bf16 phase ran, step by step."""
    X, y, _ = lasso_problem(80, 300, nnz=8, seed=31, dtype=np.float32)
    Y = _batch(X, 32) if batched else y[None]
    grid = dict(num_lambdas=12, hi_frac=0.95)
    cfg = PathConfig(solve=SolveSpec(strategy=strategy, tol=SOLVE_TOL,
                                     solve_dtype="bfloat16"))
    cfg_j = JConfig(solve=JSolve(strategy=strategy, tol=SOLVE_TOL,
                                 solve_dtype="bfloat16"))
    query = Y if batched else Y[0]
    res = LassoSession.fit(X, device="cpu", config=cfg).path(query, **grid)
    res_j = JSession.fit(X, config=cfg_j).path(jnp.asarray(query), **grid)
    B, K = Y.shape[0], 12
    np.testing.assert_allclose(res.lambdas, res_j.lambdas, rtol=2 ** -20)
    scores = _reference_scores(X, Y, res_j)
    diff = res.masks != np.asarray(res_j.masks)
    band_cols = 0
    for b in range(B):
        for k in range(K):
            if (b, k) in scores:
                band = np.abs(scores[b, k] - (1.0 - 1e-6)) <= BAND
                band_cols += int(band.sum())
                assert not (diff[b, k] & ~band).any(), (b, k)
            else:
                assert not diff[b, k].any(), (b, k)
        err = float(np.abs(res.betas[b] - np.asarray(res_j.betas[b])).max())
        assert err <= beta_err_tol(Y[b], SOLVE_TOL), (b, err)
    print(f"{strategy} B={B}: {band_cols} step-columns in the band, masks "
          f"differ at {int(diff.sum())}")
    eff = [s.solve_dtype_effective for s in res.stats]
    assert eff == [s.solve_dtype_effective for s in res_j.stats]
    lo_on = [s.solver_lo_iters > 0 for s in res.stats]
    assert lo_on == [s.solver_lo_iters > 0 for s in res_j.stats]
    live = [s for s in res.stats if s.screen_backend]
    gram = [strategy == "fista" or s.bucket <= 80 for s in live]
    assert any(gram) and [s.solve_dtype_effective for s in live] == [
        "bfloat16" if g else "float32" for g in gram]
    assert [s.solver_lo_iters > 0 for s in live] == gram
    if strategy == "cd":
        assert [s.gram_step_frac == 1.0 for s in live] == gram


def test_bf16_solve_session_keeps_the_float32_masks():
    """Against the port's own float32 path on the same session (solver
    cache reset between): masks nearly equal (a certified stop lands on
    another β than the float32 stop, which may flip a column at the
    threshold), β within beta_err_tol; each step's bytes by the
    reference's model, the bf16 phase's iteration passes at 2 bytes."""
    X, y, _ = lasso_problem(60, 400, nnz=10, seed=33, dtype=np.float32)
    sess = LassoSession.fit(X, device="cpu")
    out = {}
    for dtype in ("float32", "bfloat16"):
        sess.reset_solver_cache()
        out[dtype] = sess.path(y, num_lambdas=15, hi_frac=0.95,
                               config=PathConfig(solve=SolveSpec(
                                   tol=SOLVE_TOL, solve_dtype=dtype)))
    r32, r16 = out["float32"], out["bfloat16"]
    err = float(np.abs(r16.betas - r32.betas).max())
    assert err <= beta_err_tol(y, SOLVE_TOL)
    flips = int((r16.masks != r32.masks).sum())
    assert flips <= 2, flips
    for s32, s16 in zip(r32.stats, r16.stats):
        nb = 60 * s16.bucket
        passes = 2 * (s16.solver_iters + s16.gap_checks)
        assert s16.solve_bytes == ((passes - 2 * s16.solver_lo_iters) * nb
                                   * 4 + 2 * s16.solver_lo_iters * nb * 2)
        assert s32.solve_bytes == 2 * (s32.solver_iters + s32.gap_checks) \
            * 60 * s32.bucket * 4
    print("solve bytes bf16 / float32: "
          f"{sum(s.solve_bytes for s in r16.stats):.0f} / "
          f"{sum(s.solve_bytes for s in r32.stats):.0f}; iterations "
          f"{sum(s.solver_iters for s in r16.stats)} (bf16 phase "
          f"{sum(s.solver_lo_iters for s in r16.stats)}) / "
          f"{sum(s.solver_iters for s in r32.stats)}")
    assert all(s.solve_dtype_effective == "float32"
               for s in r32.stats if s.screen_backend)
    assert all(s.solver_lo_iters == 0 for s in r32.stats)
    assert any(s.solver_lo_iters > 0 for s in r16.stats)


def test_group_session_solves_float32_with_one_warning(monkeypatch):
    """group_fista has no bf16 phase: the bf16 request warns once per
    process and strategy, and the path is the float32 path bit for bit."""
    monkeypatch.setattr(tsolver, "_BF16_SOLVE_WARNED", set())
    X, y, _ = group_lasso_problem(40, 200, 5, active_groups=4, seed=3,
                                  dtype=np.float32)
    sess = LassoSession.fit(X, groups=5, device="cpu")
    grid = dict(num_lambdas=8, hi_frac=0.95)
    sess.reset_solver_cache()
    r32 = sess.path(y, **grid, config=PathConfig(solve=SolveSpec(
        tol=SOLVE_TOL)))
    sess.reset_solver_cache()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        r16 = sess.path(y, **grid, config=PathConfig(solve=SolveSpec(
            tol=SOLVE_TOL, solve_dtype="bfloat16")))
    hits = [w for w in caught if issubclass(w.category, RuntimeWarning)
            and "group_fista" in str(w.message)]
    assert len(hits) == 1
    np.testing.assert_array_equal(r16.masks, r32.masks)
    np.testing.assert_array_equal(r16.betas, r32.betas)
    live = [s for s in r16.stats if s.screen_backend]
    assert live and all(s.solve_dtype_effective == "float32" for s in live)
    assert all(s.solver_lo_iters == 0 for s in r16.stats)


def test_bf16_screen_and_solve_share_one_copy():
    """Both options on: the solves gather the screen's bf16 copy (made
    once per geometry) and the masks stay those of the bf16-solve path
    with a float32 screen (the bf16 screen's masks are the float32
    ones)."""
    X, y, _ = lasso_problem(60, 400, nnz=10, seed=34, dtype=np.float32)
    sess = LassoSession.fit(X, device="cpu")
    out = {}
    for screen in ("float32", "bfloat16"):
        sess.reset_solver_cache()
        out[screen] = sess.path(y, num_lambdas=12, config=PathConfig(
            screen=ScreenSpec(screen_dtype=screen),
            solve=SolveSpec(tol=SOLVE_TOL, solve_dtype="bfloat16")))
    np.testing.assert_array_equal(out["bfloat16"].masks,
                                  out["float32"].masks)
    np.testing.assert_array_equal(out["bfloat16"].betas,
                                  out["float32"].betas)
    geom = sess.geometry
    assert geom.screen_copy(torch.bfloat16) is geom.screen_copy(
        torch.bfloat16)
    assert len([k for k in geom._screen_copies if ":" not in k]) == 1
