"""The port's Lasso core on the CPU against the reference (``repro.core``)
on the same numpy inputs: objective/gap/power iteration, every sphere's
centre and radius, the plain masks, the engine's masks, and the solver
against the float64 oracle (tests/ref_lasso.py) and the reference solver;
the group-Lasso helpers, spectral norms, group EDPP/strong masks and the
group engine; the fista, cd (Gram and matvec) and group_fista strategies.

Masks: the two packages sum |Xᵀc| in different orders, so a column whose
reference score lies within BAND of the threshold 1 − eps may flip. Such
columns are counted and printed; every other column must agree. Group
scores are ‖X_gᵀc‖ of m such sums, compared the same way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ref_lasso import cd_lasso, fista_group
from repro.core import DictionaryGeometry as JGeometry
from repro.core import ScreeningEngine as JEngine
from repro.core import SolverEngine as JSolver
from repro.core import group_lasso as jgl
from repro.core import group_screening as jgs
from repro.core import lasso as jl
from repro.core import screening as jscr
from repro.core.engine import GroupDictionaryGeometry as JGroupGeometry
from repro.core.engine import GroupScreeningEngine as JGroupEngine
from repro_torch.core import group_lasso as tgl
from repro_torch.core import group_screening as tgs
from repro_torch.core import lasso as tl
from repro_torch.core import screening as tscr
from repro_torch.core.engine import (DictionaryGeometry,
                                     GroupDictionaryGeometry,
                                     GroupScreeningEngine, ScreeningEngine)
from repro_torch.core.solver import SolverEngine

TOL = dict(rtol=2e-5, atol=2e-5)
# f32 dots of n ≤ 200 terms round at ~n·2⁻²⁴·Σ|c_i x_ij| ≲ 1e-5 here;
# the band leaves 10× headroom.
BAND = 1e-4
RULES = ("dpp", "imp1", "imp2", "edpp", "seq_safe")


def beta_err_tol(y, solver_tol, kappa=25.0):
    """benchmarks/common.py: two gap-ε solutions differ by ≤ this."""
    return kappa * float(np.sqrt(solver_tol * 0.5 * float(y @ y)))


def _problem(n=60, p=300, seed=0, nnz=8):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(np.float32)
    w = np.zeros(p)
    w[rng.choice(p, nnz, replace=False)] = rng.uniform(-1, 1, nnz)
    y = (X @ w + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return X, y


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _states(X, y):
    """The λ_max state and a sequential state at 0.6·λ_max from an exact
    float64 solve, built alike in both packages. Returns (lmax, pairs)."""
    lmax = float(np.abs(X.T @ y).max())
    beta = cd_lasso(X, y, 0.6 * lmax).astype(np.float32)
    pairs = [(jscr.DualState.at_lambda_max(_j(X), _j(y)),
              tscr.DualState.at_lambda_max(_t(X), _t(y))),
             (jscr.DualState.from_solution(_j(X), _j(y), _j(beta),
                                           0.6 * lmax),
              tscr.DualState.from_solution(_t(X), _t(y), _t(beta),
                                           0.6 * lmax))]
    return lmax, pairs


def _band_agree(mask_port, mask_ref, scores_ref, eps, what):
    """Masks agree outside the rounding band; returns the band count."""
    mask_port, mask_ref = np.asarray(mask_port), np.asarray(mask_ref)
    band = np.abs(np.asarray(scores_ref) - (1.0 - eps)) <= BAND
    diff = mask_port != mask_ref
    print(f"{what}: {int(band.sum())} columns in the band, "
          f"{int(diff.sum())} differ")
    assert not (diff & ~band).any(), f"{what}: masks differ outside band"
    return int(band.sum())


def test_soft_threshold_gap_and_objectives():
    X, y = _problem()
    rng = np.random.default_rng(1)
    u = rng.standard_normal(300).astype(np.float32)
    np.testing.assert_allclose(tl.soft_threshold(_t(u), 0.5),
                               jl.soft_threshold(_j(u), 0.5), **TOL)
    beta = (rng.standard_normal(300) * (rng.uniform(size=300) < 0.05)) \
        .astype(np.float32)
    lam = 0.3 * float(np.abs(X.T @ y).max())
    for port, ref in ((tl.duality_gap, jl.duality_gap),
                      (tl.primal_objective, jl.primal_objective)):
        np.testing.assert_allclose(float(port(_t(X), _t(y), _t(beta), lam)),
                                   float(ref(_j(X), _j(y), _j(beta), lam)),
                                   rtol=1e-5)
    r = y - X @ beta
    np.testing.assert_allclose(
        float(tl.gap_from_residual(_t(r), _t(X.T @ r), _t(beta), lam, _t(y))),
        float(jl.gap_from_residual(_j(r), _j(X.T @ r), _j(beta), lam, _j(y))),
        rtol=1e-5)
    theta = y / lam
    np.testing.assert_allclose(
        float(tl.dual_objective(_t(y), _t(theta), lam)),
        float(jl.dual_objective(_j(y), _j(theta), lam)), rtol=1e-5)
    np.testing.assert_allclose(
        tl.feasible_dual_point(_t(X), _t(y), _t(beta), lam),
        jl.feasible_dual_point(_j(X), _j(y), _j(beta), lam), **TOL)


@pytest.mark.parametrize("iters", [5, 50])
def test_top_eigenpair_with_explicit_start(iters):
    X, _ = _problem(40, 120)
    v0 = np.random.default_rng(2).standard_normal(120).astype(np.float32)
    eig, v = tl.top_eigenpair(_t(X), iters=iters, v0=_t(v0))
    eig_j, v_j = jl.top_eigenpair(_j(X), iters=iters, v0=_j(v0))
    np.testing.assert_allclose(float(eig), float(eig_j), rtol=1e-5)
    np.testing.assert_allclose(v, v_j, rtol=1e-4, atol=1e-5)
    # a Rayleigh quotient: below λ_max(XᵀX), and close to it after 50
    exact = float(np.linalg.eigvalsh(X.T.astype(np.float64) @ X)[-1])
    assert float(eig) <= exact * (1 + 1e-5)
    if iters == 50:
        assert float(eig) >= 0.95 * exact
    # a cold start is seeded: the same seed gives the same estimate
    assert float(tl.power_iteration(_t(X), 20, seed=3)) \
        == float(tl.power_iteration(_t(X), 20, seed=3))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("rule", RULES + ("safe",))
def test_spheres_match_reference(rule, batched):
    X, y = _problem()
    lmax, pairs = _states(X, y)
    for (s_j, s_t), lam in zip(pairs, (0.8 * lmax, 0.45 * lmax)):
        if batched:      # B = 2 copies of the query, per-query λ
            lam_b = np.array([lam, 0.9 * lam], np.float32)
            Y2 = np.stack([y, y])
            s_j = jscr.DualState(*(jnp.stack([a, a]) for a in s_j[:3]),
                                 at_lmax=s_j.at_lmax,
                                 beta_l1=jnp.stack([s_j.beta_l1] * 2))
            s_t = tscr.DualState(*(torch.stack([torch.as_tensor(a)] * 2)
                                   for a in s_t[:3]),
                                 at_lmax=s_t.at_lmax,
                                 beta_l1=torch.stack(
                                     [torch.as_tensor(s_t.beta_l1)] * 2))
            args_j, args_t = (_j(Y2), _j(lam_b)), (_t(Y2), _t(lam_b))
        else:
            args_j, args_t = (_j(y), lam), (_t(y), lam)
        if rule == "safe":
            sp_j = jscr.safe_sphere(*args_j, lmax)
            sp_t = tscr.safe_sphere(*args_t, lmax)
        else:
            sp_j = jscr.SPHERE_RULES[rule](*args_j, s_j)
            sp_t = tscr.SPHERE_RULES[rule](*args_t, s_t)
        np.testing.assert_allclose(sp_t.centre, np.asarray(sp_j.centre),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(sp_t.rho, np.float32),
                                   np.asarray(sp_j.rho), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("rule", RULES)
def test_plain_masks_match_reference(rule):
    X, y = _problem(seed=3)
    lmax, pairs = _states(X, y)
    for (s_j, s_t), frac in zip(pairs, (0.8, 0.45)):
        lam = frac * lmax
        m_t = tscr.RULES[rule](_t(X), _t(y), lam, s_t)
        m_j = jscr.RULES[rule](_j(X), _j(y), lam, s_j)
        sp = jscr.SPHERE_RULES[rule](_j(y), lam, s_j)
        scores = np.abs(X.T @ np.asarray(sp.centre)) \
            + float(sp.rho) * np.linalg.norm(X, axis=0)
        _band_agree(m_t, m_j, scores, 1e-6, f"{rule} at {frac}·λmax")
    m_t = tscr.safe_mask(_t(X), _t(y), 0.7 * lmax, lmax)
    m_j = jscr.safe_mask(_j(X), _j(y), 0.7 * lmax, lmax)
    assert np.array_equal(np.asarray(m_t), np.asarray(m_j))


def test_dual_state_helpers_match_reference():
    X, y = _problem(seed=4)
    lmax = float(tscr.lambda_max(_t(X), _t(y)))
    np.testing.assert_allclose(lmax, float(jscr.lambda_max(_j(X), _j(y))),
                               rtol=1e-6)
    beta = cd_lasso(X, y, 0.5 * lmax).astype(np.float32)
    for lam in (lmax, 0.5 * lmax):
        s_t = tscr.make_dual_state(_t(X), _t(y), _t(beta), lam, lmax)
        s_j = jscr.make_dual_state(_j(X), _j(y), _j(beta), lam, lmax)
        assert bool(s_t.at_lmax) == bool(s_j.at_lmax)
        for a, b in zip((s_t.theta, s_t.v1), (s_j.theta, s_j.v1)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
        vp_t = tscr.v2_perp(_t(y), 0.3 * lmax, s_t)
        vp_j = jscr.v2_perp(_j(y), 0.3 * lmax, s_j)
        np.testing.assert_allclose(vp_t, np.asarray(vp_j), rtol=1e-5,
                                   atol=1e-5)
    disc = np.zeros(300, bool)
    disc[::3] = True
    lam = 0.5 * lmax
    v_t = tscr.kkt_violations(_t(X), _t(y), _t(beta * 0), lam, _t(disc))
    v_j = jscr.kkt_violations(_j(X), _j(y), _j(beta * 0), lam, _j(disc))
    assert np.array_equal(np.asarray(v_t), np.asarray(v_j))
    assert np.asarray(v_t).any()     # β = 0 below λ_max violates somewhere


@pytest.mark.parametrize("rule", RULES + ("safe", "none"))
def test_engine_screen_matches_reference_engine(rule):
    """ScreeningEngine.screen (one X pass) against the reference engine on
    the jnp backend, from the same states."""
    X, y = _problem(100, 1000, seed=5, nnz=12)
    geom = DictionaryGeometry(_t(X))
    eng = ScreeningEngine(_t(X), _t(y), geometry=geom)
    eng_j = JEngine(_j(X), _j(y), backend="jnp",
                    geometry=JGeometry(_j(X), "jnp"))
    assert geom.fit_passes == 1 and geom.query_passes == 1
    assert eng.ws.istar == eng_j.ws.istar
    np.testing.assert_allclose(eng.lam_max, eng_j.lam_max, rtol=1e-6)
    lmax = eng_j.lam_max
    beta = cd_lasso(X, y, 0.6 * lmax).astype(np.float32)
    fitted = X @ beta
    states = [(eng.state_at_lambda_max(), eng_j.state_at_lambda_max()),
              (eng.make_state(_t(beta), 0.6 * lmax, fitted=_t(fitted)),
               eng_j.make_state(_j(beta), 0.6 * lmax, fitted=_j(fitted)))]
    for (s_t, s_j), frac in zip(states, (0.85, 0.5)):
        lam = frac * lmax
        m_t = eng.screen(lam, s_t, rule=rule)
        m_j = eng_j.screen(lam, s_j, rule=rule)
        assert eng.last_x_passes == (0 if rule == "none" else 1)
        assert eng.last_x_passes == eng_j.last_x_passes
        if rule == "none":
            assert not np.asarray(m_t).any()
            continue
        sp = (jscr.safe_sphere(_j(y), lam, lmax) if rule == "safe"
              else jscr.SPHERE_RULES[rule](_j(y), lam, s_j))
        scores = np.abs(X.T @ np.asarray(sp.centre)) \
            + float(sp.rho) * np.linalg.norm(X, axis=0)
        eps = 1e-6 / lam if rule == "safe" else 1e-6
        _band_agree(m_t, m_j, scores, eps, f"engine {rule} at {frac}·λmax")
    with pytest.raises(NotImplementedError, match="item 8"):
        eng.screen(0.5 * lmax, states[1][0], rule="gap")


@pytest.mark.parametrize("frac", [0.7, 0.3, 0.1])
def test_solver_matches_oracle_and_reference_solver(frac):
    """FISTA at tol 1e-6 against the float64 CD oracle and the reference's
    SolverEngine started from the same power-iteration vector."""
    X, y = _problem(50, 200, seed=6)
    lam = frac * float(np.abs(X.T @ y).max())
    v0 = np.random.default_rng(7).standard_normal(200).astype(np.float32)
    eng = SolverEngine(_t(y), tol=1e-6, eig_cache={200: _t(v0)})
    eng_j = JSolver(_j(y), backend="jnp", tol=1e-6,
                    eig_cache={200: _j(v0)})
    res = eng.solve(_t(X), lam)
    res_j = eng_j.solve(_j(X), lam)
    exact = cd_lasso(X, y, lam)
    tol = beta_err_tol(y, 1e-6)
    assert res.converged and bool(res_j.converged)
    assert np.abs(res.beta.numpy() - exact).max() <= tol
    assert np.abs(res.beta.numpy() - np.asarray(res_j.beta)).max() <= tol
    assert res.iters == int(res_j.iters)     # same start, same arithmetic
    assert res.gap_checks == int(res_j.gap_checks) == eng.last_gap_checks
    assert eng.last_x_passes == 2 * res.iters + 2 * res.gap_checks
    assert eng._eig_stats == {"warm": 1, "cold": 0}


def _group_problem(n=60, p=300, m=5, seed=0, active=4):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(np.float32)
    w = np.zeros(p)
    for g in rng.choice(p // m, active, replace=False):
        w[g * m:(g + 1) * m] = rng.uniform(-1, 1, m)
    y = (X @ w + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return X, y


def _group_band_agree(mask_port, mask_ref, scores_ref, thresh_ref, what):
    """Group masks agree outside BAND of the reference's threshold;
    returns the band count (printed)."""
    mask_port, mask_ref = np.asarray(mask_port), np.asarray(mask_ref)
    band = np.abs(np.asarray(scores_ref) - np.asarray(thresh_ref)) <= BAND
    diff = mask_port != mask_ref
    print(f"{what}: {int(band.sum())} groups in the band, "
          f"{int(diff.sum())} differ")
    assert not (diff & ~band).any(), f"{what}: masks differ outside band"
    return int(band.sum())


@pytest.mark.parametrize("m", [2, 5, 10])
def test_group_lasso_helpers_match_reference(m):
    X, y = _group_problem(m=m, seed=m)
    rng = np.random.default_rng(10 + m)
    u = rng.standard_normal(300).astype(np.float32)
    np.testing.assert_allclose(tgl.group_soft_threshold(_t(u), 0.3, m),
                               jgl.group_soft_threshold(_j(u), 0.3, m),
                               **TOL)
    lmax = float(tgl.group_lambda_max(_t(X), _t(y), m))
    np.testing.assert_allclose(
        lmax, float(jgl.group_lambda_max(_j(X), _j(y), m)), rtol=1e-6)
    lam = 0.4 * lmax
    beta = fista_group(X, y, lam, m, tol=1e-10).astype(np.float32)
    for port, ref in ((tgl.group_primal, jgl.group_primal),
                      (tgl.group_duality_gap, jgl.group_duality_gap)):
        np.testing.assert_allclose(
            float(port(_t(X), _t(y), _t(beta), lam, m)),
            float(ref(_j(X), _j(y), _j(beta), lam, m)), rtol=1e-4,
            atol=1e-4)
    r = y - X @ beta
    np.testing.assert_allclose(
        float(tgl.group_gap_from_residual(_t(r), _t(X.T @ r), _t(beta), lam,
                                          m, _t(y))),
        float(jgl.group_gap_from_residual(_j(r), _j(X.T @ r), _j(beta), lam,
                                          m, _j(y))), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m", [2, 5, 10])
def test_group_spectral_norms_match_reference(m):
    """‖X_g‖₂ through torch.linalg.eigvalsh against the reference's
    jnp.linalg.eigvalsh and against numpy's float64 2-norm."""
    X, _ = _group_problem(m=m, seed=20 + m)
    sn = tgs.group_spectral_norms(_t(X), m)
    assert sn.shape == (300 // m,)
    np.testing.assert_allclose(sn, np.asarray(
        jgs.group_spectral_norms(_j(X), m)), rtol=1e-5)
    exact = [np.linalg.norm(X[:, g * m:(g + 1) * m].astype(np.float64), 2)
             for g in range(300 // m)]
    np.testing.assert_allclose(sn, exact, rtol=1e-5)


def _group_states(X, y, m):
    """The λ̄_max state and a sequential state at 0.6·λ̄_max from the
    float64 group oracle, built alike in both packages."""
    lmax = float(jgl.group_lambda_max(_j(X), _j(y), m))
    beta = fista_group(X, y, 0.6 * lmax, m, tol=1e-10).astype(np.float32)
    pairs = [(jgs.group_state_at_lambda_max(_j(X), _j(y), m),
              tgs.group_state_at_lambda_max(_t(X), _t(y), m)),
             (jgs.group_state_from_solution(_j(X), _j(y), _j(beta),
                                            0.6 * lmax),
              tgs.group_state_from_solution(_t(X), _t(y), _t(beta),
                                            0.6 * lmax))]
    return lmax, beta, pairs


@pytest.mark.parametrize("m", [2, 5, 10])
def test_group_masks_match_reference(m):
    X, y = _group_problem(m=m, seed=30 + m)
    lmax, beta, pairs = _group_states(X, y, m)
    sqm = np.sqrt(m)
    spec = np.asarray(jgs.group_spectral_norms(_j(X), m))
    for (s_j, s_t), frac in zip(pairs, (0.8, 0.45)):
        # v̄₁ = y/λ − θ cancels: compare at 1e-6 of the vector's scale
        for a, b in ((s_t.theta, s_j.theta), (s_t.v1, s_j.v1)):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-6 * np.abs(b).max())
        lam = frac * lmax
        vp = np.asarray(jgs.group_v2_perp(_j(y), lam, s_j))
        np.testing.assert_allclose(tgs.group_v2_perp(_t(y), lam, s_t), vp,
                                   rtol=1e-4, atol=1e-5)
        centre = np.asarray(s_j.theta) + 0.5 * vp
        scores = np.linalg.norm((X.T.astype(np.float64) @ centre)
                                .reshape(-1, m), axis=1)
        _group_band_agree(
            tgs.group_edpp_mask(_t(X), _t(y), lam, s_t, m),
            jgs.group_edpp_mask(_j(X), _j(y), lam, s_j, m), scores,
            sqm - 0.5 * np.linalg.norm(vp) * spec - 1e-6,
            f"group edpp m={m} at {frac}·λmax")
        resid = np.asarray(s_j.theta) * float(s_j.lam)
        scores = np.linalg.norm((X.T.astype(np.float64) @ resid)
                                .reshape(-1, m), axis=1)
        _group_band_agree(
            tgs.group_strong_mask(_t(X), _t(y), lam, s_t, m),
            jgs.group_strong_mask(_j(X), _j(y), lam, s_j, m), scores,
            sqm * (2 * lam - float(s_j.lam)) - 1e-6,
            f"group strong m={m} at {frac}·λmax")
    disc = np.zeros(300 // m, bool)
    disc[::2] = True
    lam = 0.5 * lmax
    v_t = tgs.group_kkt_violations(_t(X), _t(y), _t(beta * 0), lam,
                                   _t(disc), m)
    v_j = jgs.group_kkt_violations(_j(X), _j(y), _j(beta * 0), lam,
                                   _j(disc), m)
    assert np.array_equal(np.asarray(v_t), np.asarray(v_j))
    assert np.asarray(v_t).any()     # β = 0 below λ̄_max violates somewhere


@pytest.mark.parametrize("rule", ["edpp", "strong", "none"])
def test_group_engine_matches_reference_engine(rule):
    """GroupScreeningEngine.screen (one group_scores pass) against the
    reference's group engine on the jnp backend, from the same states."""
    m = 5
    X, y = _group_problem(100, 1000, m=m, seed=40, active=6)
    geom = GroupDictionaryGeometry(_t(X), m)
    eng = GroupScreeningEngine(_t(X), _t(y), m, geometry=geom)
    eng_j = JGroupEngine(_j(X), _j(y), m, backend="jnp",
                         geometry=JGroupGeometry(_j(X), m, "jnp"))
    assert geom.fit_passes == 1 and geom.query_passes == 1
    np.testing.assert_allclose(eng.lam_max, eng_j.lam_max, rtol=1e-6)
    # v̄₁ = X*X*ᵀy names the argmax group: equal rays, equal g*
    np.testing.assert_allclose(eng.state_at_lambda_max().v1,
                               np.asarray(eng_j.v1_at_lmax),
                               rtol=1e-5, atol=1e-4)
    lmax = eng_j.lam_max
    beta = fista_group(X, y, 0.6 * lmax, m, tol=1e-10).astype(np.float32)
    fitted = X @ beta
    states = [(eng.state_at_lambda_max(), eng_j.state_at_lambda_max()),
              (eng.make_state(_t(beta), 0.6 * lmax, fitted=_t(fitted)),
               eng_j.make_state(_j(beta), 0.6 * lmax, fitted=_j(fitted)))]
    spec = np.asarray(eng_j.spec_norms)
    np.testing.assert_allclose(eng.spec_norms, spec, rtol=1e-5)
    for (s_t, s_j), frac in zip(states, (0.85, 0.5)):
        lam = frac * lmax
        m_t = eng.screen(lam, s_t, rule=rule)
        m_j = eng_j.screen(lam, s_j, rule=rule)
        assert eng.last_x_passes == eng_j.last_x_passes \
            == (0 if rule == "none" else 1)
        assert m_t.shape == (1000 // m,)
        if rule == "none":
            assert not np.asarray(m_t).any()
            continue
        if rule == "edpp":
            vp = np.asarray(jgs.group_v2_perp(_j(y), lam, s_j))
            centre = np.asarray(s_j.theta) + 0.5 * vp
            thresh = np.sqrt(m) - 0.5 * np.linalg.norm(vp) * spec - 1e-6
        else:
            centre = np.asarray(s_j.theta) * float(s_j.lam)
            thresh = np.sqrt(m) * (2 * lam - float(s_j.lam)) - 1e-6
        scores = np.linalg.norm((X.T.astype(np.float64) @ centre)
                                .reshape(-1, m), axis=1)
        _group_band_agree(m_t, m_j, scores, thresh,
                          f"group engine {rule} at {frac}·λmax")
    with pytest.raises(ValueError, match="group screens take rules"):
        eng.screen(0.5 * lmax, states[1][0], rule="dpp")


@pytest.mark.parametrize("shape, gram", [((50, 32), True), ((40, 200), False)])
@pytest.mark.parametrize("frac", [0.7, 0.3])
def test_cd_matches_oracle_and_reference_solver(shape, gram, frac):
    """The ``cd`` strategy on a bucket below the Gram crossover
    (``_cd_gram_solve`` through the plain sweep) and above it
    (``_cd_solve``), at tol 1e-6, against the float64 CD oracle and the
    reference's SolverEngine; the crossover, pass accounting and the gap
    checks match."""
    n, p = shape
    X, y = _problem(n, p, seed=8 + p, nnz=5)
    X[:, -2:] = 0.0                   # padded bucket columns stay at 0
    lam = frac * float(np.abs(X.T @ y).max())
    eng = SolverEngine(_t(y), solver="cd", tol=1e-6)
    eng_j = JSolver(_j(y), solver="cd", backend="jnp", tol=1e-6)
    res = eng.solve(_t(X), lam)
    res_j = eng_j.solve(_j(X), lam)
    exact = cd_lasso(X, y, lam)
    tol = beta_err_tol(y, 1e-6)
    assert eng.last_used_gram is gram is eng_j.last_used_gram
    assert res.converged and bool(res_j.converged)
    assert np.abs(res.beta.numpy() - exact).max() <= tol
    assert np.abs(res.beta.numpy() - np.asarray(res_j.beta)).max() <= tol
    assert not res.beta[-2:].any()
    assert res.gap_checks == eng.last_gap_checks
    print(f"cd {shape} at {frac}·λmax: epochs {res.iters} (reference "
          f"{int(res_j.iters)}), gap checks {res.gap_checks}")
    want = (1.0 + res.iters * p / n if gram else float(res.iters)) \
        + 2.0 * res.gap_checks
    assert eng.last_x_passes == pytest.approx(want)


@pytest.mark.parametrize("m", [2, 5])
def test_group_fista_matches_oracle_and_reference_solver(m):
    """``group_fista`` at tol 1e-6 from the same power-iteration vector,
    against the float64 group oracle and the reference solver."""
    X, y = _group_problem(50, 100, m=m, seed=50 + m, active=3)
    lam = 0.4 * float(jgl.group_lambda_max(_j(X), _j(y), m))
    v0 = np.random.default_rng(9).standard_normal(100).astype(np.float32)
    eng = SolverEngine(_t(y), solver="group_fista", tol=1e-6,
                       eig_cache={100: _t(v0)})
    eng_j = JSolver(_j(y), solver="group_fista", backend="jnp", tol=1e-6,
                    eig_cache={100: _j(v0)})
    res = eng.solve(_t(X), lam, m=m)
    res_j = eng_j.solve(_j(X), lam, m=m)
    exact = fista_group(X, y, lam, m)
    tol = beta_err_tol(y, 1e-6)
    assert res.converged and bool(res_j.converged)
    assert np.abs(res.beta.numpy() - exact).max() <= tol
    assert np.abs(res.beta.numpy() - np.asarray(res_j.beta)).max() <= tol
    print(f"group_fista m={m}: iterations {res.iters} (reference "
          f"{int(res_j.iters)})")
    assert eng.last_x_passes == 2 * res.iters + 2 * res.gap_checks
