"""The other screening rules on the CPU: GAP, DOME, the strong rule, the
``*_cut`` composites and hybrid safe+strong, in the port
(``repro_torch.core``) against the reference (``repro.core``) on the same
numpy inputs, and against the port's own oracles.

The contract, per test:

* each oracle (``gap_mask``, ``strong_mask``, ``dome_mask``, every
  ``CUT_RULES`` entry; single and batched) agrees with the reference's
  outside BAND of the threshold (columns in the band counted and
  printed); ``halfspace_sup``, ``cut_from_ray`` and ``feasibility_cut``
  agree to float32 rounding;
* the engine's screen is bit for bit the port's oracle from the same
  state, and a batched screen bit for bit each query's single screen;
* GAP screens with its feasibility rescale ‖Xᵀθ₀‖∞: a test fails if the
  engine screened with θ₀ assumed feasible;
* ``LassoSession.path`` against the reference's session for every new
  rule (sequential and basic), hybrid safe+strong, and the strong rule
  with ``max_kkt_rounds`` 0 and 10: masks equal outside the band of the
  scores each step tested (for the strong rule and hybrid, also of the
  KKT check), β within ``beta_err_tol(y, 1e-6)``, ``x_passes`` and
  ``kkt_rounds`` equal, ``n_discarded`` and ``bucket`` equal where no
  mask flipped;
* each query of a (B, n) batch against its single run: masks equal, β
  within ``beta_err_tol``; group hybrid against the reference;
* the reference's properties (tests/test_screening.py): DOME tighter than
  SAFE, a degenerate cut equal to the sphere bit for bit, cut ⊇ base,
  the strong rule's KKT loop re-adding what it wrongly discarded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ref_lasso import cd_lasso
from repro.core import LassoSession as JSession
from repro.core import PathConfig as JConfig
from repro.core import ScreenSpec as JScreen
from repro.core import SolveSpec as JSolve
from repro.core import screening as jscr
from repro.data.pipeline import group_lasso_problem, lasso_problem
from repro_torch import (LassoSession, PathConfig, ScreenSpec, SolveSpec,
                         session_from_arrays)
from repro_torch.core import screening as tscr
from repro_torch.core.engine import (ENGINE_RULES, DictionaryGeometry,
                                     ScreeningEngine, engine_x_passes)
from repro_torch.data import QueryStream

BAND = 1e-4          # score units around each threshold
EPS = 1e-6
TOL = 1e-6
KKT_TOL = 1e-4
GRID = dict(num_lambdas=20, hi_frac=0.95)
CUTS = tuple(sorted(tscr.CUT_RULES))
NEW_RULES = ("gap", "strong", "dome", *CUTS)


def beta_err_tol(y, solver_tol, kappa=25.0):
    """benchmarks/common.py: two gap-ε solutions differ by ≤ this."""
    y = np.asarray(y, np.float64)
    return kappa * float(np.sqrt(solver_tol * 0.5 * float(y @ y)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _problem(n=60, p=300, seed=0, nnz=8):
    X, y, _ = lasso_problem(n, p, nnz=nnz, seed=seed, dtype=np.float32)
    return X, y


def _lam_max(X, y):
    return float(np.abs(X.T.astype(np.float64) @ y).max())


# ---------------------------------------------------------------------------
# the scores each rule tests, in float64, for the rounding band
# ---------------------------------------------------------------------------

def _state64(theta, lam, v1, beta_l1):
    return tscr.DualState(
        theta=torch.as_tensor(np.asarray(theta, np.float64)), lam=float(lam),
        v1=torch.as_tensor(np.asarray(v1, np.float64)), at_lmax=False,
        beta_l1=torch.tensor(float(beta_l1), dtype=torch.float64))


def rule_scores(rule, X, y, lam, state, lam_max, eps=EPS):
    """[(scores (p,), threshold)] that ``rule`` tests for one query at λ
    from ``state`` (a float64 :class:`~repro_torch.core.screening.
    DualState`), in float64 through the port's functions: a column whose
    score lies within BAND of its threshold may flip between two float32
    evaluations. GAP's scores are moved toward the threshold by ‖x_j‖
    times the float32 rounding of its radius (:func:`gap_radius_err`)."""
    X = torch.as_tensor(np.asarray(X, np.float64))
    y = torch.as_tensor(np.asarray(y, np.float64))
    norms = tscr.col_norms(X)
    if rule == "none":
        return []
    if rule == "strong":
        dot = X.T @ (state.theta * state.lam)
        return [(torch.abs(dot).numpy(),
                 tscr.strong_threshold(lam, state.lam, eps))]
    if rule == "safe":
        sp = tscr.safe_sphere(y, lam, lam_max)
        return [((torch.abs(X.T @ sp.centre) + sp.rho * norms).numpy(),
                 1.0 - eps / lam)]
    if rule == "dome":
        cut = tscr.feasibility_cut(X, y)
        c = y / lam
        rho = tscr._norm(y) * (1.0 / lam - 1.0 / lam_max)
        return [(tscr.dome_scores(X.T @ c, X.T @ cut.ghat, norms, c, rho,
                                  cut.ghat, cut.b).numpy(), 1.0 - eps)]
    base = rule[:-4] if rule.endswith("_cut") else rule
    widen = 0.0
    if base == "gap":
        dot = X.T @ state.theta
        sup = tscr.sup_corr(dot)
        test = tscr.gap_sphere(y, lam, state, sup_corr=sup)
        scores_c = dot / torch.clamp(sup, min=1.0)
        plain = tscr.gap_scores(dot, test, sup, norms)
        widen = gap_radius_err(y, lam, state, sup) * norms.numpy()
    else:
        test = tscr.SPHERE_RULES[base](y, lam, state)
        scores_c = X.T @ test.centre
        plain = torch.abs(scores_c) + test.rho * norms
    if base != rule:
        cut = tscr.feasibility_cut(X, y)
        plain = tscr.halfspace_sup(scores_c, X.T @ cut.ghat, norms, test,
                                   cut)
    # a score within ``widen`` of the threshold counts as on it
    scores = plain.numpy() - 1.0 + eps
    scores = np.sign(scores) * np.maximum(np.abs(scores) - widen, 0.0)
    return [(scores + 1.0 - eps, 1.0 - eps)]


def gap_radius_err(y, lam, state, sup) -> float:
    """How far GAP's float32 radius √(2·G)/λ may round from its float64
    value: G = P − D cancels primal and dual values far larger than it,
    and each is a float32 tree sum of depth ≤ 16, so G may be off by
    δG = 16·2⁻²⁴·(|P| + |D|)."""
    centre = state.theta / torch.clamp(sup, min=1.0)
    resid = state.theta * state.lam
    primal = 0.5 * float(resid @ resid) + lam * float(state.beta_l1)
    dual = 0.5 * float(y @ y) - 0.5 * lam * lam * float(
        torch.sum(torch.square(centre - y / lam)))
    gap = max(primal - dual, 0.0)
    d_gap = 16 * 2.0 ** -24 * (abs(primal) + abs(dual))
    return (np.sqrt(2 * (gap + d_gap))
            - np.sqrt(2 * max(gap - d_gap, 0.0))) / lam


def path_bands(X, y, lambdas, betas, rule, *, sequential=True,
               hybrid=False, kkt=False, kkt_tol=KKT_TOL):
    """Per step of a path (its grid and β), the columns within BAND of a
    threshold the step tested, from the path's own previous solution
    (None where λ ≥ λ_max): the rule's, the strong rule's too under
    hybrid, and the KKT check's |x_jᵀr|/λ against 1 + tol where the path
    runs it."""
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    lmax = _lam_max(X, y)
    i = int(np.argmax(np.abs(X64.T @ y64)))
    v1max = np.sign(X64[:, i] @ y64) * X64[:, i]
    state0 = _state64(y64 / lmax, lmax, v1max, 0.0)
    state, out = state0, []
    for lam, beta in zip(lambdas, betas):
        if lam >= lmax:
            out.append(None)
            continue
        rules = [rule] + (["strong"] if hybrid else [])
        band = np.zeros(X.shape[1], dtype=bool)
        for r in rules:
            for scores, thr in rule_scores(r, X, y, lam, state, lmax):
                band |= np.abs(scores - thr) <= BAND
        if kkt:
            corr = np.abs(X64.T @ (y64 - X64 @ beta)) / lam
            band |= np.abs(corr - (1.0 + kkt_tol)) <= BAND
        out.append(band)
        if sequential:
            theta = (y64 - X64 @ beta) / lam
            state = _state64(theta, lam, y64 / lam - theta,
                             np.abs(beta).sum())
    return out


def check_path(res_t, res_j, X, y, rule, what, **band_kw):
    """The session contract between the port's path and a reference path
    (both single-query results with their leading axis)."""
    np.testing.assert_allclose(res_t.lambdas, res_j.lambdas, rtol=2 ** -22,
                               atol=0)
    bands = path_bands(X, y, res_j.lambdas[0], res_j.betas[0], rule,
                       **band_kw)
    in_band = 0
    for k, (s_t, s_j) in enumerate(zip(res_t.stats, res_j.stats)):
        diff = res_t.masks[0, k] != res_j.masks[0, k]
        if bands[k] is None:
            assert not diff.any(), (what, k)
        else:
            in_band += int(bands[k].sum())
            assert not (diff & ~bands[k]).any(), (what, k, "outside band")
        assert (s_t.x_passes, s_t.kkt_rounds) == (s_j.x_passes,
                                                  s_j.kkt_rounds), (what, k)
        if not diff.any():
            assert (s_t.n_discarded, s_t.bucket) == (s_j.n_discarded,
                                                     s_j.bucket), (what, k)
    err = float(np.abs(res_t.betas - res_j.betas).max())
    print(f"{what}: {in_band} step-columns in the band; masks differ at "
          f"{int((res_t.masks != res_j.masks).sum())}; max|Δβ| {err:.3g}; "
          f"kkt rounds {sum(s.kkt_rounds for s in res_t.stats)}")
    assert err <= beta_err_tol(y, TOL), (what, err)
    assert bool(res_t.query_converged[0]) == bool(res_j.query_converged[0])


# ---------------------------------------------------------------------------
# oracles against the reference
# ---------------------------------------------------------------------------

def _states(X, y):
    """(λ_max, [(reference state, port state)]): the λ_max state, a
    sequential state from an exact float64 solve at 0.6·λ_max, and an
    inexact one (that β scaled by 0.7), whose θ₀ is not dual feasible."""
    lmax = _lam_max(X, y)
    beta = cd_lasso(X, y, 0.6 * lmax).astype(np.float32)
    pairs = [(jscr.DualState.at_lambda_max(_j(X), _j(y)),
              tscr.DualState.at_lambda_max(_t(X), _t(y)))]
    for b in (beta, 0.7 * beta):
        pairs.append((jscr.DualState.from_solution(_j(X), _j(y), _j(b),
                                                   0.6 * lmax),
                      tscr.DualState.from_solution(_t(X), _t(y), _t(b),
                                                   0.6 * lmax)))
    return lmax, pairs


def _as64(state):
    return _state64(state.theta, float(state.lam), state.v1,
                    float(state.beta_l1))


def _agree(m_t, m_j, bands, what):
    m_t, m_j = np.asarray(m_t), np.asarray(m_j)
    band = np.zeros(m_t.shape, dtype=bool)
    for scores, thr in bands:
        band |= np.abs(scores - thr) <= BAND
    diff = m_t != m_j
    print(f"{what}: {int(band.sum())} columns in the band, "
          f"{int(diff.sum())} differ; {int(m_t.sum())} discarded")
    assert not (diff & ~band).any(), f"{what}: masks differ outside band"


def _oracle(pkg, rule, X, y, lam, state, lmax):
    if rule == "dome":
        return pkg.dome_mask(X, y, lam, lmax)
    return pkg.RULES[rule](X, y, lam, state)


@pytest.mark.parametrize("rule", NEW_RULES)
def test_oracles_match_reference(rule):
    X, y = _problem(seed=3)
    lmax, pairs = _states(X, y)
    for (s_j, s_t), frac in zip(pairs, (0.8, 0.45, 0.45)):
        lam = frac * lmax
        m_t = _oracle(tscr, rule, _t(X), _t(y), lam, s_t, lmax)
        m_j = _oracle(jscr, rule, _j(X), _j(y), lam, s_j, lmax)
        _agree(m_t, m_j, rule_scores(rule, X, y, lam, _as64(s_t), lmax),
               f"{rule} at {frac}·λmax")


def _stack_states(pairs):
    """B = 2 states: query 0 the first pair's, query 1 the second's."""
    (j0, t0), (j1, t1) = pairs
    s_j = jscr.DualState(theta=jnp.stack([j0.theta, j1.theta]),
                         lam=jnp.stack([jnp.asarray(j0.lam, jnp.float32),
                                        jnp.asarray(j1.lam, jnp.float32)]),
                         v1=jnp.stack([j0.v1, j1.v1]), at_lmax=False,
                         beta_l1=jnp.stack([jnp.asarray(j0.beta_l1),
                                            jnp.asarray(j1.beta_l1)]))
    s_t = tscr.DualState(
        theta=torch.stack([t0.theta, t1.theta]),
        lam=torch.stack([torch.as_tensor(t0.lam), torch.as_tensor(t1.lam)]),
        v1=torch.stack([t0.v1, t1.v1]), at_lmax=np.array([True, False]),
        beta_l1=torch.stack([torch.as_tensor(t0.beta_l1),
                             torch.as_tensor(t1.beta_l1)]))
    return s_j, s_t


@pytest.mark.parametrize("rule", NEW_RULES)
def test_batched_oracles_match_reference_and_single(rule):
    """B = 2 queries (y and 0.7·y + noise, each from its own state, at its
    own λ): the batched oracle against the reference's batched oracle and
    against the port's single oracle of each query, outside the band."""
    X, y = _problem(seed=4)
    rng = np.random.default_rng(4)
    y2 = (0.7 * y + 0.1 * rng.standard_normal(y.shape)).astype(np.float32)
    Y = np.stack([y, y2])
    lmaxes = [_lam_max(X, y), _lam_max(X, y2)]
    _, pairs0 = _states(X, y)
    _, pairs1 = _states(X, y2)
    singles = [pairs0[0], pairs1[1]]
    s_j, s_t = _stack_states(singles)
    lam = np.array([0.7 * lmaxes[0], 0.45 * lmaxes[1]], np.float32)
    lmax_b = np.array(lmaxes, np.float32)
    if rule == "dome":
        m_t = tscr.dome_mask(_t(X), _t(Y), _t(lam), _t(lmax_b))
        m_j = jscr.dome_mask(_j(X), _j(Y), _j(lam), _j(lmax_b))
    else:
        m_t = tscr.RULES[rule](_t(X), _t(Y), _t(lam), s_t)
        m_j = jscr.RULES[rule](_j(X), _j(Y), _j(lam), s_j)
    assert m_t.shape == (2, X.shape[1])
    for b in range(2):
        bands = rule_scores(rule, X, Y[b], float(lam[b]),
                            _as64(singles[b][1]), float(lmax_b[b]))
        _agree(m_t[b], m_j[b], bands, f"batched {rule} query {b}")
        one = _oracle(tscr, rule, _t(X), _t(Y[b]), float(lam[b]),
                      singles[b][1], float(lmax_b[b]))
        _agree(m_t[b], one, bands, f"batched {rule} query {b} vs single")


def test_cut_geometry_matches_reference():
    X, y = _problem(seed=5)
    Y = np.stack([y, -0.5 * y])
    for arg in (y, Y):
        c_t = tscr.feasibility_cut(_t(X), _t(arg))
        c_j = jscr.feasibility_cut(_j(X), _j(arg))
        np.testing.assert_allclose(c_t.ghat, np.asarray(c_j.ghat), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(c_t.b, np.asarray(c_j.b), rtol=1e-6)
        r_t = tscr.cut_from_ray(_t(arg))
        r_j = jscr.cut_from_ray(_j(arg))
        np.testing.assert_allclose(r_t.ghat, np.asarray(r_j.ghat), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(r_t.b, np.asarray(r_j.b), rtol=1e-6)
    # the sup over a ball that the cut passes through (t_b ≈ 0.3)
    rng = np.random.default_rng(11)
    c = rng.standard_normal(X.shape[0]).astype(np.float32)
    g = rng.standard_normal(X.shape[0])
    ghat = (g / np.linalg.norm(g)).astype(np.float32)
    rho = 0.8
    b = np.float32(ghat @ c + 0.3 * rho)
    sups = []
    for pkg, conv in ((tscr, _t), (jscr, _j)):
        test = pkg.SphereTest(centre=conv(c), rho=conv(np.float32(rho)))
        cut = pkg.HalfSpaceCut(ghat=conv(ghat), b=conv(b))
        sups.append(np.asarray(pkg.halfspace_sup(
            conv(X.T @ c), conv(X.T @ ghat),
            conv(np.linalg.norm(X, axis=0)), test, cut)))
    np.testing.assert_allclose(sups[0], sups[1], rtol=2e-6, atol=2e-6)
    sphere = np.abs(X.T @ c) + rho * np.linalg.norm(X, axis=0)
    assert (sups[0] <= sphere + 1e-4).all() and (sups[0] < sphere).any()


# ---------------------------------------------------------------------------
# the engine against the port's oracles, bit for bit
# ---------------------------------------------------------------------------

def _engine_states(eng, X, y, lmax):
    """The engine's λ_max state, a sequential state from an exact solve
    at 0.6·λ_max, and an inexact one whose θ₀ is not feasible."""
    beta = cd_lasso(X, y, 0.6 * lmax).astype(np.float32)
    states = [eng.state_at_lambda_max()]
    for b in (beta, 0.7 * beta):
        states.append(eng.make_state(_t(b), 0.6 * lmax,
                                     fitted=_t(X @ b)))
    return states


@pytest.mark.parametrize("rule", NEW_RULES)
def test_engine_matches_port_oracles_bit_for_bit(rule):
    X, y = _problem(100, 1000, seed=5, nnz=12)
    Xt, yt = _t(X), _t(y)
    eng = ScreeningEngine(Xt, yt, geometry=DictionaryGeometry(Xt))
    lmax = eng.lam_max
    for state in _engine_states(eng, X, y, lmax):
        for frac in (0.85, 0.5, 0.3):
            lam = frac * lmax
            got = eng.screen(lam, state, rule=rule)
            assert eng.last_x_passes == engine_x_passes(rule)
            want = _oracle(tscr, rule, Xt, yt, lam, state, lmax)
            np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                          err_msg=f"{rule} at {frac}")


def test_gap_screens_with_its_feasibility_rescale():
    """Trouble spot: GAP and gap_cut must take sup_corr = ‖Xᵀθ₀‖∞ from
    their own matvec. Here θ₀ is the exact dual point at 0.6·λ_max scaled
    by 1.05, as an inexact solve leaves it: ‖Xᵀθ₀‖∞ = 1.05. The engine's
    masks must be the oracles', and safe; the sphere that trusts θ₀ to
    be feasible (``make_sphere("gap", ...)``, sup_corr=None) discards
    over a hundred more columns here, so an engine that screened with it
    fails."""
    X, y = _problem(80, 600, seed=6, nnz=10)
    Xt, yt = _t(X), _t(y)
    eng = ScreeningEngine(Xt, yt, geometry=DictionaryGeometry(Xt))
    lmax = eng.lam_max
    beta = _t(cd_lasso(X, y, 0.6 * lmax).astype(np.float32))
    state = eng.make_state(beta, 0.6 * lmax, fitted=Xt @ beta)
    state = state._replace(theta=1.05 * state.theta)
    assert float(tscr.sup_corr(Xt.T @ state.theta)) == pytest.approx(1.05)
    lam = 0.55 * lmax
    active = np.abs(cd_lasso(X, y, lam)) > 1e-10
    trusting = {
        "gap": tscr.sphere_mask(Xt, tscr.make_sphere("gap", yt, lam, state)),
        "gap_cut": tscr.cut_mask(Xt, tscr.make_sphere("gap", yt, lam, state),
                                 tscr.feasibility_cut(Xt, yt))}
    for rule, wrong in trusting.items():
        got = eng.screen(lam, state, rule=rule).numpy()
        np.testing.assert_array_equal(
            got, tscr.RULES[rule](Xt, yt, lam, state).numpy())
        assert got.any() and not (got & active).any(), rule
        assert (got != wrong.numpy()).sum() > 100, rule


@pytest.mark.parametrize("batch", [8, 12])
@pytest.mark.parametrize("rule", NEW_RULES)
def test_batched_screens_match_single_screens(rule, batch):
    """(B, n) screens from a batched state against each query's single
    engine from its own state, bit for bit; the passes are the single
    rule's for the whole batch (a B = 12 cut screen stacks 24 rows)."""
    st = QueryStream(n=40, p=200, batch=batch, nnz=10, seed=3)
    X, Y = st.dictionary(np.float32), st.host_batch(0)["y"].astype(
        np.float32)
    Xt, Yt = _t(X), _t(Y)
    geom = DictionaryGeometry(Xt)
    eng = ScreeningEngine(Xt, Yt, geometry=geom)
    singles = [ScreeningEngine(Xt, Yt[b].clone(), geometry=geom)
               for b in range(batch)]
    lam_max = np.asarray(eng.lam_max)
    lam_prev = 0.6 * lam_max
    beta = torch.stack([_t(cd_lasso(X, Y[b], lam_prev[b]).astype(
        np.float32)) for b in range(batch)])
    beta[::2] *= 0.7                   # half the queries inexact
    fitted = beta @ Xt.T
    states = [(eng.state_at_lambda_max(),
               [s.state_at_lambda_max() for s in singles]),
              (eng.make_state(beta, lam_prev, fitted=fitted),
               [s.make_state(beta[b].clone(), float(lam_prev[b]),
                             fitted=fitted[b].clone())
                for b, s in enumerate(singles)])]
    lam = (0.5 * lam_max).astype(np.float32)
    for state, per_query in states:
        got = eng.screen(lam, state, rule).numpy()
        assert got.shape == (batch, X.shape[1])
        assert eng.last_x_passes == engine_x_passes(rule)
        for b in range(batch):
            want = singles[b].screen(float(lam[b]), per_query[b], rule)
            np.testing.assert_array_equal(got[b], want.numpy(),
                                          err_msg=f"{rule} query {b}")


def test_engine_serves_every_rule_and_refuses_others():
    assert set(ENGINE_RULES) == {*jscr.RULES, "safe", "dome", "none"}
    X, y = _problem(20, 50, seed=1, nnz=3)
    eng = ScreeningEngine(_t(X), _t(y))
    with pytest.raises(ValueError, match="unknown screening rule"):
        eng.screen(0.5 * eng.lam_max, eng.state_at_lambda_max(), "bogus")


# ---------------------------------------------------------------------------
# LassoSession.path against the reference
# ---------------------------------------------------------------------------

def _sessions(X, screen_kw):
    js = JSession.fit(X, config=JConfig(screen=JScreen(**screen_kw),
                                        solve=JSolve(tol=TOL)))
    arrays = {"X": np.asarray(js.geometry.X),
              "sumsq": np.asarray(js.geometry.sumsq)}
    ts = session_from_arrays(arrays, device="cpu", config=PathConfig(
        screen=ScreenSpec(**screen_kw), solve=SolveSpec(tol=TOL)))
    return js, ts


PATH_CASES = [(r, True) for r in NEW_RULES] + [
    ("gap", False), ("strong", False), ("dome", False), ("edpp_cut", False),
    ("gap_cut", False)]


@pytest.mark.parametrize("rule, sequential", PATH_CASES)
def test_path_matches_reference_session(rule, sequential):
    X, y, _ = lasso_problem(50, 400, nnz=10, seed=60, dtype=np.float32)
    kw = dict(rule=rule, sequential=sequential)
    js, ts = _sessions(X, kw)
    res_j = js.path(jnp.asarray(y), **GRID)
    res_t = ts.path(y, **GRID)
    check_path(res_t, res_j, X, y, rule, f"{rule} seq={sequential}",
               sequential=sequential, kkt=rule == "strong")
    live = [s for s in res_t.stats if s.screen_backend]
    assert all(s.x_passes == engine_x_passes(rule) for s in live)
    assert ts.backend_name == "torch"


@pytest.mark.parametrize("rule, sequential", [
    ("edpp", True), ("gap", True), ("gap_cut", True), ("safe", False),
    ("dome", False)])
def test_hybrid_matches_reference_session(rule, sequential):
    """Hybrid safe+strong: the strong discards ORed into the safe rule's,
    the KKT loop after; a step's x_passes is the base rule's plus 1."""
    X, y, _ = lasso_problem(50, 400, nnz=10, seed=61, dtype=np.float32)
    kw = dict(rule=rule, sequential=sequential, strong=True)
    js, ts = _sessions(X, kw)
    res_j = js.path(jnp.asarray(y), **GRID)
    res_t = ts.path(y, **GRID)
    check_path(res_t, res_j, X, y, rule, f"hybrid {rule}",
               sequential=sequential, hybrid=True, kkt=True)
    live = [s for s in res_t.stats if s.screen_backend]
    assert all(s.x_passes == engine_x_passes(rule) + 1 for s in live)
    # the strong discards can only add to the safe rule's
    alone = ts.path(y, **GRID, config=PathConfig(
        screen=ScreenSpec(rule=rule, sequential=sequential),
        solve=SolveSpec(tol=TOL)))
    assert sum(s.n_discarded for s in res_t.stats) \
        >= sum(s.n_discarded for s in alone.stats)


@pytest.mark.parametrize("rounds", [0, 10])
def test_strong_rule_kkt_rounds_match_reference(rounds):
    X, y, _ = lasso_problem(50, 400, nnz=10, seed=62, corr=0.5,
                            dtype=np.float32)
    kw = dict(rule="strong", max_kkt_rounds=rounds)
    js, ts = _sessions(X, kw)
    res_j = js.path(jnp.asarray(y), **GRID)
    res_t = ts.path(y, **GRID)
    check_path(res_t, res_j, X, y, "strong", f"strong rounds={rounds}",
               kkt=True)
    none = ts.path(y, **GRID, config=PathConfig(
        screen=ScreenSpec(rule="none"), solve=SolveSpec(tol=TOL)))
    assert np.abs(res_t.betas - none.betas).max() <= beta_err_tol(y, TOL)


class _Overeager:
    """A screening engine whose strong screen discards every feature: the
    KKT loop must re-add each active one."""

    def __init__(self, eng):
        self.eng = eng

    def __getattr__(self, name):
        return getattr(self.eng, name)

    def screen(self, lam, state, rule="edpp"):
        mask = self.eng.screen(lam, state, rule)
        return torch.ones_like(mask) if rule == "strong" else mask


@pytest.mark.parametrize("rule, strong", [("strong", False),
                                          ("edpp", True)])
def test_kkt_loop_readds_wrongly_discarded_features(monkeypatch, rule,
                                                    strong):
    """The strong rule (and hybrid) run the KKT loop: with a strong screen
    that discards everything, the violations are re-added round by round
    and the path still equals the unscreened one; with
    ``max_kkt_rounds=0`` the loop stops at once and the path is wrong."""
    import repro_torch.core.session as tsess
    X, y, _ = lasso_problem(40, 200, nnz=6, seed=7, dtype=np.float32)
    sess = LassoSession.fit(X, device="cpu")
    none = sess.path(y, **GRID, config=PathConfig(
        screen=ScreenSpec(rule="none"), solve=SolveSpec(tol=TOL)))
    real = tsess.ScreeningEngine
    monkeypatch.setattr(tsess, "ScreeningEngine",
                        lambda *a, **k: _Overeager(real(*a, **k)))
    for rounds in (10, 0):
        res = sess.path(y, **GRID, config=PathConfig(
            screen=ScreenSpec(rule=rule, strong=strong,
                              max_kkt_rounds=rounds),
            solve=SolveSpec(tol=TOL)))
        kkt = [s.kkt_rounds for s in res.stats]
        err = float(np.abs(res.betas - none.betas).max())
        if rounds:
            assert max(kkt) > 0 and err <= beta_err_tol(y, TOL), (kkt, err)
        else:
            assert max(kkt) == 0 and err > beta_err_tol(y, TOL)


# ---------------------------------------------------------------------------
# batched queries against their single runs; group hybrid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule, strong", [
    ("gap", False), ("strong", False), ("edpp_cut", False), ("dome", False),
    ("gap_cut", False), ("edpp", True)])
def test_batched_path_reproduces_single_runs(rule, strong):
    st = QueryStream(n=40, p=200, batch=8, nnz=10, seed=3)
    X, Y = st.dictionary(np.float32), st.host_batch(0)["y"].astype(
        np.float32)
    grids = np.stack([np.linspace(0.95, 0.05, 8) * _lam_max(X, y)
                      for y in Y])
    sess = LassoSession.fit(X, device="cpu")
    cfg = PathConfig(screen=ScreenSpec(rule=rule, strong=strong),
                     solve=SolveSpec(tol=TOL))
    res = sess.path(Y, grids, config=cfg)
    assert res.masks.shape == (8, 8, 200)
    for b in range(8):
        one = sess.path(Y[b], grids[b], config=cfg)
        np.testing.assert_array_equal(res.masks[b], one.masks[0],
                                      err_msg=f"{rule} query {b}")
        err = float(np.abs(res.betas[b] - one.betas[0]).max())
        assert err <= beta_err_tol(Y[b], TOL), (b, err)
    passes = engine_x_passes(rule) + int(strong)
    live = [s for s in res.stats if s.screen_backend]
    assert all(s.x_passes == passes and s.x_passes_per_query == passes / 8
               for s in live)


def _group_bands(X, y, m, lambdas, betas, spec):
    """Per step of a group path, the groups within BAND of group EDPP's,
    group strong's or the KKT check's threshold, from the path's own
    previous solution (float64)."""
    X64, y64 = X.astype(np.float64), y.astype(np.float64)

    def gnorm(v):
        return np.linalg.norm(v.reshape(-1, m), axis=1)

    g0 = gnorm(X64.T @ y64) / np.sqrt(m)
    gi = int(np.argmax(g0))
    lmax = g0[gi]
    Xg = X64[:, gi * m:(gi + 1) * m]
    theta, lam0, v1 = y64 / lmax, lmax, Xg @ (Xg.T @ y64)
    out = []
    for lam, beta in zip(lambdas, betas):
        if lam >= lmax:
            out.append(None)
            continue
        v2 = y64 / lam - theta
        vp = v2 - (v1 @ v2) / (v1 @ v1) * v1
        band = np.abs(gnorm(X64.T @ (theta + 0.5 * vp))
                      - (np.sqrt(m) - 0.5 * np.linalg.norm(vp) * spec
                         - EPS)) <= BAND
        band |= np.abs(gnorm(X64.T @ (theta * lam0))
                       - (np.sqrt(m) * (2 * lam - lam0) - EPS)) <= BAND
        kkt = gnorm(X64.T @ (y64 - X64 @ beta)) / (lam * np.sqrt(m))
        band |= np.abs(kkt - (1 + KKT_TOL)) <= BAND
        out.append(band)
        theta, lam0 = (y64 - X64 @ beta) / lam, lam
        v1 = y64 / lam - theta
    return out


def test_group_hybrid_matches_reference_session():
    """Group EDPP ORed with group strong and the KKT loop, on a reference
    group session carried over by ``session_from_arrays``."""
    m = 5
    X, y, _ = group_lasso_problem(60, 300, m, active_groups=4, seed=7,
                                  dtype=np.float32)
    cfg_j = JConfig(screen=JScreen(rule="edpp", strong=True),
                    solve=JSolve(tol=TOL))
    cfg_t = PathConfig(screen=ScreenSpec(rule="edpp", strong=True),
                       solve=SolveSpec(tol=TOL))
    js = JSession.fit(X, groups=m, config=cfg_j)
    spec = np.asarray(js.geometry.spec_norms)
    ts = session_from_arrays({"X": X, "groups": m, "spec_norms": spec},
                             config=cfg_t, device="cpu")
    res_j = js.path(jnp.asarray(y), **GRID)
    res_t = ts.path(y, **GRID)
    bands = _group_bands(X, y, m, res_j.lambdas[0], res_j.betas[0],
                         spec.astype(np.float64))
    for k, (s_t, s_j) in enumerate(zip(res_t.stats, res_j.stats)):
        diff = res_t.masks[0, k] != res_j.masks[0, k]
        if bands[k] is None:
            assert not diff.any(), k
        else:
            assert not (diff & ~bands[k]).any(), (k, "outside band")
        assert s_t.x_passes == s_j.x_passes == (2 if s_t.screen_backend
                                                else 0), k
        assert s_t.kkt_rounds == s_j.kkt_rounds, k
        if not diff.any():
            assert (s_t.n_discarded, s_t.bucket) == (s_j.n_discarded,
                                                     s_j.bucket), k
    err = float(np.abs(res_t.betas - res_j.betas).max())
    assert err <= beta_err_tol(y, TOL), err
    edpp = ts.path(y, **GRID, config=PathConfig(solve=SolveSpec(tol=TOL)))
    assert sum(s.n_discarded for s in res_t.stats) \
        >= sum(s.n_discarded for s in edpp.stats)


# ---------------------------------------------------------------------------
# the reference's properties (tests/test_screening.py)
# ---------------------------------------------------------------------------

def test_dome_tighter_than_safe():
    """The dome lies inside SAFE's ball: it discards at least as much."""
    X, y = _problem(40, 250, seed=5)
    Xn = (X / np.linalg.norm(X, axis=0, keepdims=True)).astype(np.float32)
    yn = (y / np.linalg.norm(y)).astype(np.float32)
    lmax = float(tscr.lambda_max(_t(Xn), _t(yn)))
    for frac in (0.7, 0.4):
        lam = frac * lmax
        safe = tscr.safe_mask(_t(Xn), _t(yn), lam, lmax)
        dome = tscr.dome_mask(_t(Xn), _t(yn), lam, lmax)
        assert int(dome.sum()) >= int(safe.sum())
        assert not (safe & ~dome).any()


def test_degenerate_cut_is_the_sphere_bit_for_bit():
    X, y = _problem(40, 200, seed=12)
    Xt, yt = _t(X), _t(y)
    lmax = float(tscr.lambda_max(Xt, yt))
    state = tscr.DualState.at_lambda_max(Xt, yt)
    test = tscr.make_sphere("edpp", yt, 0.4 * lmax, state)
    g = np.random.default_rng(1).standard_normal(X.shape[0])
    ghat = _t((g / np.linalg.norm(g)).astype(np.float32))
    far = float(torch.linalg.vector_norm(test.centre)) + 2 * float(test.rho)
    cut = tscr.HalfSpaceCut(ghat=ghat, b=torch.tensor(far + 1.0))
    norms = tscr.col_norms(Xt)
    scores_c = Xt.T @ test.centre
    sups = tscr.halfspace_sup(scores_c, Xt.T @ ghat, norms, test, cut)
    np.testing.assert_array_equal(
        sups.numpy(), (torch.abs(scores_c) + test.rho * norms).numpy())


@pytest.mark.parametrize("base", sorted(tscr.SPHERE_RULES))
def test_cut_discards_superset_of_base(base):
    X, y = _problem(40, 250, seed=10)
    lmax = _lam_max(X, y)
    Xt, yt = _t(X), _t(y)
    for beta in (cd_lasso(X, y, 0.6 * lmax), 0.7 * cd_lasso(X, y,
                                                            0.6 * lmax)):
        state = tscr.make_dual_state(Xt, yt, _t(beta.astype(np.float32)),
                                     0.6 * lmax, lmax)
        for lam in (0.45 * lmax, 0.25 * lmax):
            m_base = tscr.RULES[base](Xt, yt, lam, state)
            m_cut = tscr.CUT_RULES[base + "_cut"](Xt, yt, lam, state)
            assert not (m_base & ~m_cut).any(), (base, lam)
            # and it is safe: no feature active at λ is discarded
            active = np.abs(cd_lasso(X, y, lam)) > 1e-10
            assert not (m_cut.numpy() & active).any(), (base, lam)
