"""The mixed-precision screen (``screen_dtype="bfloat16"``) on the CPU, in
the port (``repro_torch``) against the reference (``repro``) on the same
numpy inputs, and against the port's own float32 screen.

The contract, per test:

* ``bf16_column_err`` and ``bf16_score_margin`` agree with the
  reference's within 1e-6 relative (the bf16 copies are the same bits:
  both round to nearest even), and the margin dominates the true error of
  a bf16 dot for one centre and for (B, n) centres; the interval bound
  ``dome_score_bounds`` agrees with the reference's and holds the exact
  cap sup;
* the engine, for every rule of ``BF16_FAST_RULES`` at λ/λ_max ∈ {0.8,
  0.5, 0.2}: the bf16 mask is the port's float32 mask bit for bit, with
  fewer screen bytes and at most one extra pass, and the reference's bf16
  mask outside BAND of the threshold (the columns in the band counted);
* three planted cases (the reference's ``tests/test_kernels.py``): a SAFE
  ladder across the threshold inside the bf16 band, a DOME ladder, and an
  ``edpp_cut`` ladder at the corner of the cut's two regimes: the
  fallback fires and the masks are equal;
* the plain version's dots of an (n, k) gather of X are the whole X's
  bits at the gathered columns (what the float32 re-test needs);
* session paths (edpp, gap, gap_cut; one query and a batch of 8): bf16
  masks equal to float32 masks at every step, every screened step in
  bf16, ``x_passes`` and ``n_discarded`` those of the reference's bf16
  run;
* what is refused: group sessions (``ValueError``, as the reference).

Tolerances: the margins are float32 reductions taken in another order
in each package (1e-6 relative); masks are compared bit for bit within
the port, and outside BAND of the threshold against the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LassoSession as JSession
from repro.core import PathConfig as JConfig
from repro.core import ScreeningEngine as JEngine
from repro.core import ScreenSpec as JScreen
from repro.core import SolveSpec as JSolve
from repro.core import screening as jscr
from repro.data.pipeline import lasso_problem
from repro.kernels import ops as jops
from repro_torch import (LassoSession, PathConfig, ScreenSpec, SolveSpec,
                         session_from_arrays)
from repro_torch.core import screening as tscr
from repro_torch.core.engine import (BF16_FAST_RULES, DictionaryGeometry,
                                     ScreeningEngine, _narrow_bucket)
from repro_torch.kernels import ops, ref
from test_torch_rules import _state64, rule_scores

BAND = 1e-4        # score units around the threshold
EPS = 1e-6
TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _engines(X, y):
    """The port's float32 and bf16 engines on one geometry, and the
    reference's bf16 engine, from the same numpy arrays."""
    Xt, yt = _t(X), _t(y)
    geom = DictionaryGeometry(Xt)
    e32 = ScreeningEngine(Xt, yt, geometry=geom)
    e16 = ScreeningEngine(Xt, yt, geometry=geom, screen_dtype="bfloat16")
    j16 = JEngine(jnp.asarray(X), jnp.asarray(y), backend="jnp",
                  screen_dtype="bfloat16")
    return e32, e16, j16


# ---------------------------------------------------------------------------
# the margins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(40, 120), (100, 1000)])
def test_bf16_margins_match_reference(shape):
    rng = np.random.default_rng(5)
    X = rng.standard_normal(shape).astype(np.float32)
    Xb = _t(X).to(torch.bfloat16)
    Xj = jnp.asarray(X)
    # the same screen copy: both round to nearest even
    np.testing.assert_array_equal(Xb.float().numpy(), np.asarray(
        Xj.astype(jnp.bfloat16).astype(jnp.float32)))
    err = ops.bf16_column_err(_t(X), Xb)
    err_j = jops.bf16_column_err(Xj, Xj.astype(jnp.bfloat16))
    assert err.dtype == torch.float32 and err.shape == (shape[1],)
    np.testing.assert_allclose(err.numpy(), np.asarray(err_j), rtol=1e-6)
    norms = rng.uniform(0.5, 3.0, 3).astype(np.float32)
    for cn in (float(norms[0]), _t(norms)):
        got = ops.bf16_score_margin(err, cn)
        want = jops.bf16_score_margin(err_j, jnp.asarray(np.asarray(cn)))
        assert got.shape == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    geom = DictionaryGeometry(_t(X))
    assert geom.screen_copy(torch.bfloat16) is geom.screen_copy(
        torch.bfloat16)
    assert torch.equal(geom.screen_err(torch.bfloat16), err)
    assert geom.screen_copy(torch.float32) is geom.X
    assert not geom.screen_err(torch.float32).any()


@pytest.mark.parametrize("batch", [1, 8])
def test_bf16_margin_dominates_the_true_dot_error(batch):
    """Cauchy-Schwarz: |x̂ᵀc − xᵀc| ≤ ‖Δx‖‖c‖, for the plain float32 dots
    of the bf16 copy against those of X."""
    rng = np.random.default_rng(6)
    X = _t(rng.standard_normal((40, 120)).astype(np.float32))
    lead = () if batch == 1 else (batch,)
    C = _t(rng.standard_normal(lead + (40,)).astype(np.float32) * 3.0)
    Xb = X.to(torch.bfloat16)
    err = ops.bf16_column_err(X, Xb)
    gap = torch.abs(ref.screen_matvec_ref(Xb, C) - ref.screen_matvec_ref(X, C))
    margin = ops.bf16_score_margin(err, torch.linalg.vector_norm(C, dim=-1))
    assert margin.shape == gap.shape
    assert bool((gap <= margin).all())
    assert bool((gap > 0).any())


@pytest.mark.parametrize("batch", [1, 4])
def test_dome_score_bounds_match_reference_and_hold_the_sup(batch):
    """The interval bound on the cap sup against the reference's on the
    same inputs (float32 rounding), and the exact ``cap_scores`` of any
    point of the intervals inside [lo, hi]."""
    rng = np.random.default_rng(9)
    lead = () if batch == 1 else (batch,)
    p = 200
    norms = rng.uniform(0.5, 2.0, p).astype(np.float32)
    s = rng.uniform(-1.5, 1.5, lead + (p,)).astype(np.float32)
    g = (rng.uniform(-1.0, 1.0, lead + (p,)) * norms).astype(np.float32)
    e = rng.uniform(0.0, 0.05, lead + (p,)).astype(np.float32)
    rho = rng.uniform(0.05, 0.5, lead).astype(np.float32)
    t_b = rng.uniform(-0.9, 0.9, lead).astype(np.float32)
    args = (s - e, s + e, g - e, g + e, norms, rho, rho, t_b, t_b)
    lo, hi = tscr.dome_score_bounds(*(_t(np.asarray(a)) for a in args))
    lo_j, hi_j = jscr.dome_score_bounds(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(lo.numpy(), np.asarray(lo_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(hi.numpy(), np.asarray(hi_j), rtol=1e-5,
                               atol=1e-6)
    col = (lambda v: _t(np.asarray(v))[..., None]) if batch > 1 \
        else (lambda v: _t(np.asarray(v)))
    for w in (-1.0, -0.3, 0.0, 0.6, 1.0):
        exact = tscr.cap_scores(_t(s + w * e), _t(g - w * e), _t(norms),
                                col(rho), col(t_b))
        assert bool((exact >= lo - 1e-5).all() and (exact <= hi + 1e-5)
                    .all()), w


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _reference_band(rule, X, y, lam, lmax):
    """Columns within BAND of the threshold ``rule`` tests at λ from the
    λ_max state (float64, through the port's functions)."""
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    i = int(np.argmax(np.abs(X64.T @ y64)))
    v1 = np.sign(X64[:, i] @ y64) * X64[:, i]
    state = _state64(y64 / lmax, lmax, v1, 0.0)
    band = np.zeros(X.shape[1], dtype=bool)
    for scores, thr in rule_scores(rule, X, y, lam, state, lmax):
        band |= np.abs(scores - thr) <= BAND
    return band


@pytest.mark.parametrize("rule", BF16_FAST_RULES)
def test_bf16_engine_masks_are_the_float32_masks(rule):
    rng = np.random.default_rng(7)
    n, p = 48, 320
    X = rng.standard_normal((n, p)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    e32, e16, j16 = _engines(X, y)
    st, st_j = e32.state_at_lambda_max(), j16.state_at_lambda_max()
    band_cols = 0
    for frac in (0.8, 0.5, 0.2):
        lam = frac * e32.lam_max
        m32 = e32.screen(lam, st, rule).numpy()
        m16 = e16.screen(lam, st, rule).numpy()
        np.testing.assert_array_equal(m16, m32, err_msg=f"{rule}@{frac}")
        assert e16.last_effective_dtype == "bfloat16"
        assert e32.last_effective_dtype == "float32"
        assert e16.last_screen_bytes < e32.last_screen_bytes
        assert e16.last_x_passes <= e32.last_x_passes + 1
        mj = np.asarray(j16.screen(lam, st_j, rule))
        band = _reference_band(rule, X, y, lam, e32.lam_max)
        band_cols += int(band.sum())
        assert not ((m16 != mj) & ~band).any(), f"{rule}@{frac}"
    print(f"{rule}: {band_cols} columns in the band")


def test_bf16_engine_none_streams_nothing():
    rng = np.random.default_rng(8)
    X = rng.standard_normal((20, 64)).astype(np.float32)
    y = rng.standard_normal(20).astype(np.float32)
    _, e16, _ = _engines(X, y)
    m = e16.screen(0.5 * e16.lam_max, None, "none")
    assert not m.any() and e16.last_x_passes == 0
    assert e16.last_effective_dtype == "float32"
    with pytest.raises(ValueError, match="screen_dtype"):
        ScreeningEngine(_t(X), _t(y), screen_dtype="float16")


def test_bf16_planted_safe_band_falls_back():
    """SAFE columns planted on a ladder of scores across the threshold,
    inside the bf16 band: the fallback fires (wide pass + one narrow
    re-test) and the mask is the float32 one, split inside the ladder."""
    rng = np.random.default_rng(17)
    n, p = 32, 256
    X = rng.standard_normal((n, p)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    yn = (y / np.linalg.norm(y)).astype(np.float64)
    lmax = float(np.abs(X.astype(np.float64).T @ y.astype(np.float64)).max())
    lam = 0.5 * lmax
    thresh = 1.0 - EPS / lam
    ynorm = float(np.linalg.norm(y.astype(np.float64)))
    slope = ynorm * (2.0 / lam - 1.0 / lmax)
    alpha_star = thresh / slope
    assert alpha_star * ynorm < 0.9 * lmax
    band = 2.0 * (2.0 ** -9) / np.sqrt(3.0) * alpha_star * ynorm / lam
    n_plant = 24
    for j, d in enumerate(np.linspace(-band, band, n_plant)):
        X[:, j] = ((alpha_star + d / slope) * yn).astype(np.float32)
    e32, e16, _ = _engines(X, y)
    lam = 0.5 * e32.lam_max
    m32 = e32.screen(lam, None, "safe").numpy()
    m16 = e16.screen(lam, None, "safe").numpy()
    np.testing.assert_array_equal(m16, m32)
    assert e16.last_fallback_cols > 0, "planted band never triggered"
    assert e16.last_x_passes == 2
    bucket = _narrow_bucket(e16.last_fallback_cols, p)
    assert e16.last_screen_bytes == n * p * 2 + n * bucket * 4
    planted = m32[:n_plant]
    assert planted.any() and not planted.all()


def _dome_pieces(X, y, lam):
    """(c, rho, ghat, b_cut, istar, lam_max) of the dome at λ, float64."""
    corr = np.asarray(X, np.float64).T @ np.asarray(y, np.float64)
    istar = int(np.argmax(np.abs(corr)))
    lmax = float(np.abs(corr[istar]))
    g = np.sign(corr[istar]) * np.asarray(X[:, istar], np.float64)
    gnorm = float(np.linalg.norm(g))
    ghat = (g / gnorm).astype(np.float32)
    b_cut = np.float32(1.0 / gnorm)
    c = (np.asarray(y, np.float64) / lam).astype(np.float32)
    rho = np.float32(np.linalg.norm(y) * (1.0 / lam - 1.0 / lmax))
    return c, rho, ghat, b_cut, istar, lmax


def _plant_sup_ladder(X, cols, deltas, centre, rho, ghat, b_cut, dirs=None):
    """Scale (or overwrite with ``dirs``) the columns so that their cap sup
    lands at (1 − eps)·(1 + δ): the sup is positively homogeneous in the
    column."""
    for j, d in zip(cols, deltas):
        xj = np.asarray(X[:, j] if dirs is None else dirs[j], np.float64)
        sup = float(jscr.dome_scores(
            jnp.asarray([xj @ centre], jnp.float32),
            jnp.asarray([xj @ ghat], jnp.float32),
            jnp.asarray([np.linalg.norm(xj)], jnp.float32),
            jnp.asarray(centre), jnp.asarray(rho), jnp.asarray(ghat),
            jnp.asarray(b_cut))[0])
        X[:, j] = (xj * (1.0 - EPS) * (1.0 + d) / sup).astype(np.float32)


def test_bf16_planted_dome_boundary_falls_back():
    rng = np.random.default_rng(23)
    n, p, n_plant = 32, 256, 16
    X = rng.standard_normal((n, p)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    lam = 0.5 * float(np.max(np.abs(X.astype(np.float64).T @ y)))
    c, rho, ghat, b_cut, istar, lmax = _dome_pieces(X, y, lam)
    cols = [j for j in range(p - n_plant - 1, p) if j != istar][:n_plant]
    _plant_sup_ladder(X, cols, np.linspace(-2.5e-3, 2.5e-3, n_plant), c,
                      rho, ghat, b_cut)
    corr = np.abs(X.T @ y)
    assert int(np.argmax(corr)) == istar
    assert float(np.max(corr[cols])) < 0.9 * lmax
    e32, e16, _ = _engines(X, y)
    st = e32.state_at_lambda_max()
    m32 = e32.screen(lam, st, "dome").numpy()
    m16 = e16.screen(lam, st, "dome").numpy()
    np.testing.assert_array_equal(m16, m32)
    assert e16.last_fallback_cols > 0, "planted dome band never triggered"
    # one stacked bf16 pass for both directions, plus the re-test
    assert e16.last_x_passes == 2 and e32.last_x_passes == 2
    planted = m32[cols]
    assert planted.any() and not planted.all()
    assert not m32[istar]


def test_bf16_planted_cut_corner_falls_back():
    """edpp_cut columns at the corner of the cut's two regimes
    (t* = ĝᵀx/‖x‖ ≈ t_b) with their sup on a ladder across the threshold:
    both per-piece margins are live; the masks are equal, the fallback
    fires."""
    rng = np.random.default_rng(29)
    n, p, n_plant = 32, 256, 16
    X = rng.standard_normal((n, p)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    corr = np.abs(X.astype(np.float64).T @ y)
    istar = int(np.argmax(corr))
    lmax = float(corr[istar])
    _, _, ghat, b_cut, _, _ = _dome_pieces(X, y, 0.5 * lmax)
    st_j = jscr.DualState.at_lambda_max(jnp.asarray(X), jnp.asarray(y))
    lam = None
    for frac in (0.5, 0.7, 0.3, 0.9):
        test = jscr.make_sphere("edpp", jnp.asarray(y), frac * lmax, st_j)
        centre = np.asarray(test.centre, np.float64)
        rho_s = float(test.rho)
        t_b = float(jscr.dome_t_b(test.centre, test.rho, jnp.asarray(ghat),
                                  jnp.asarray(b_cut)))
        if -0.95 < t_b < 0.95:
            lam = frac * lmax
            break
    assert lam is not None, "no λ with an interior clipping corner"
    u = rng.standard_normal(n)
    u -= (u @ ghat) * ghat.astype(np.float64)
    u /= np.linalg.norm(u)
    cols = [j for j in range(p - n_plant - 1, p) if j != istar][:n_plant]
    t_off = np.linspace(-0.02, 0.02, n_plant)
    dirs = {j: np.clip(t_b + dt, -0.99, 0.99) * ghat.astype(np.float64)
            + np.sqrt(1.0 - np.clip(t_b + dt, -0.99, 0.99) ** 2) * u
            for j, dt in zip(cols, t_off)}
    _plant_sup_ladder(X, cols, np.linspace(-2.5e-3, 2.5e-3, n_plant),
                      centre.astype(np.float32), rho_s, ghat, b_cut,
                      dirs=dirs)
    corr2 = np.abs(X.T @ y)
    assert int(np.argmax(corr2)) == istar
    assert float(np.max(corr2[cols])) < 0.9 * lmax
    e32, e16, _ = _engines(X, y)
    st = e32.state_at_lambda_max()
    m32 = e32.screen(lam, st, "edpp_cut").numpy()
    m16 = e16.screen(lam, st, "edpp_cut").numpy()
    np.testing.assert_array_equal(m16, m32)
    assert e16.last_fallback_cols > 0, "planted corner band never triggered"
    planted = m32[cols]
    assert planted.any() and not planted.all()


@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("k", [8, 24, 48])
def test_plain_dots_of_a_gather_are_the_whole_widths_bits(k, rows):
    """The float32 re-test's dots: the plain version on an (n, k) gather
    (and on its zero-padded bucket) equals the (n, p) product bit for bit
    at the gathered columns, for one centre, 8 and 16 stacked rows."""
    rng = np.random.default_rng(100 + k + rows)
    n, p = 300, 2000
    X = _t(rng.standard_normal((n, p)).astype(np.float32))
    lead = () if rows == 1 else (rows,)
    C = _t(rng.standard_normal(lead + (n,)).astype(np.float32))
    full = ref.screen_matvec_ref(X, C)
    cols = np.sort(rng.choice(p, k, replace=False))
    Xn = X[:, cols].contiguous()
    assert torch.equal(ref.screen_matvec_ref(Xn, C, wide_p=p),
                       full[..., cols])
    bucket = _narrow_bucket(k + 1, p)
    Xp = torch.zeros((n, bucket))
    Xp[:, :k] = X[:, cols]
    got = ref.screen_matvec_ref(Xp, C)
    assert torch.equal(got[..., :k], full[..., cols])
    assert not got[..., k:].any()


# ---------------------------------------------------------------------------
# session paths
# ---------------------------------------------------------------------------

def _batch(X, seed, B=8):
    """A (B, n) batch of responses of 10-sparse truths on X."""
    rng = np.random.default_rng(seed)
    n, p = X.shape
    Y = np.empty((B, n), np.float32)
    for b in range(B):
        w = np.zeros(p)
        idx = rng.choice(p, 10, replace=False)
        w[idx] = rng.uniform(-1.0, 1.0, 10)
        Y[b] = X @ w + 0.1 * rng.standard_normal(n)
    return Y


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("rule", ["edpp", "gap", "gap_cut"])
def test_bf16_session_path_is_the_float32_path(rule, batched):
    X, y, _ = lasso_problem(50, 400, nnz=10, seed=23, dtype=np.float32)
    Y = _batch(X, 24) if batched else y
    grid = dict(num_lambdas=20, hi_frac=0.95)
    js = JSession.fit(X)
    arrays = {"X": np.asarray(js.geometry.X),
              "sumsq": np.asarray(js.geometry.sumsq)}
    ts = session_from_arrays(arrays, device="cpu")

    def cfgs(dtype):
        return (PathConfig(screen=ScreenSpec(rule=rule, screen_dtype=dtype),
                           solve=SolveSpec(tol=TOL)),
                JConfig(screen=JScreen(rule=rule, screen_dtype=dtype),
                        solve=JSolve(tol=TOL)))

    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg, _ = cfgs(dtype)
        ts.reset_solver_cache()
        out[dtype] = ts.path(Y, config=cfg, **grid)
    r32, r16 = out["float32"], out["bfloat16"]
    np.testing.assert_array_equal(r16.masks, r32.masks)
    np.testing.assert_array_equal(r16.betas, r32.betas)
    screened = [s for s in r16.stats if s.screen_backend]
    assert screened and all(s.screen_dtype_effective == "bfloat16"
                            for s in screened)
    assert all(s.screen_dtype_effective == "float32"
               for s in r32.stats if s.screen_backend)
    assert sum(s.screen_bytes for s in r16.stats) \
        < sum(s.screen_bytes for s in r32.stats)
    if rule != "edpp":        # the candidate gather: always one more pass
        assert all(s.x_passes == 2 for s in screened)
    js.reset_solver_cache()
    res_j = js.path(jnp.asarray(Y), config=cfgs("bfloat16")[1], **grid)
    assert [s.x_passes for s in r16.stats] == [s.x_passes
                                               for s in res_j.stats]
    assert [s.n_discarded for s in r16.stats] == [s.n_discarded
                                                  for s in res_j.stats]
    print(f"{rule} B={r16.batch}: re-tested columns "
          f"{[s.fallback_cols for s in screened]}")


def test_bf16_hybrid_reports_both_screens():
    """Hybrid safe+strong in bf16: the base rule's dtype, both screens'
    passes and re-tested columns, and the float32 run's masks."""
    X, y, _ = lasso_problem(50, 400, nnz=10, seed=31, dtype=np.float32)
    sess = LassoSession.fit(X, device="cpu")
    out = {}
    for dtype in ("float32", "bfloat16"):
        sess.reset_solver_cache()
        out[dtype] = sess.path(y, num_lambdas=20, config=PathConfig(
            screen=ScreenSpec(rule="edpp", strong=True, screen_dtype=dtype),
            solve=SolveSpec(tol=TOL)))
    np.testing.assert_array_equal(out["bfloat16"].masks,
                                  out["float32"].masks)
    screened = [s for s in out["bfloat16"].stats if s.screen_backend]
    assert all(s.screen_dtype_effective == "bfloat16" for s in screened)
    assert all(2 <= s.x_passes <= 4 for s in screened)


def test_group_sessions_refuse_a_bf16_screen():
    X = np.random.default_rng(0).standard_normal((20, 40)).astype(np.float32)
    cfg = PathConfig(screen=ScreenSpec(screen_dtype="bfloat16"))
    with pytest.raises(ValueError, match="screen_dtype='float32' only"):
        LassoSession.fit(X, groups=4, config=cfg, device="cpu")
    sess = LassoSession.fit(X, groups=4, device="cpu")
    with pytest.raises(ValueError, match="screen_dtype='float32' only"):
        sess.path(X[:, 0], num_lambdas=3, config=cfg)
