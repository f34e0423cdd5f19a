"""The batched multi-query path on the CPU: ``LassoSession.path(Y)`` with
Y (B, n) against B single-query runs of the port and against the
reference's batched session, on the same numpy problems
(``QueryStream``, N, P, B, K = 40, 200, 8, 8 as in
tests/test_batched_path.py).

The contract, per test:

* the port's ``QueryStream`` draws the reference's arrays bit for bit;
* a batched screen is bit for bit the per-query screens from the same
  state, one pass over X for the batch;
* the batched path against B single port runs: masks equal, β within
  ``beta_err_tol(y_b, tol)``;
* against the reference's batched session (tol 1e-6, ``hi_frac=0.95``):
  grids to f32 rounding, masks equal except for columns whose reference
  score lies within BAND of the threshold (counted and printed), β within
  ``beta_err_tol``, ``query_converged``, ``batch_size``,
  ``x_passes_per_query`` and ``bucket`` equal;
* a converged query's β does not move by one bit in more iterations;
* a query in its trivial region stays at β = 0 and discards everything.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LassoSession as JSession
from repro.core import PathConfig as JConfig
from repro.core import ScreeningEngine as JEngine
from repro.core import SolveSpec as JSolve
from repro.core import screening as jscr
from repro.data.pipeline import QueryStream as JStream
from repro.data.pipeline import group_lasso_problem
from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
from repro_torch.core import (SOLVERS, DictionaryGeometry, ScreeningEngine,
                              SolverEngine, register_solver)
from repro_torch.core.engine import engine_x_passes
from repro_torch.data import QueryStream

N, P, B, K = 40, 200, 8, 8
BAND = 1e-4
TOL = 1e-6
# λ_max (and the grids made from it) to a few float32 ulps: both packages
# sum n float32 products, in different orders
LMAX_RTOL = 2 ** -20
RULES = ("dpp", "imp1", "imp2", "edpp", "seq_safe", "safe", "none")


def beta_err_tol(y, solver_tol, kappa=25.0):
    """benchmarks/common.py: two gap-ε solutions differ by ≤ this."""
    y = np.asarray(y, np.float64)
    return kappa * float(np.sqrt(solver_tol * 0.5 * float(y @ y)))


def _stream(b=B, n=N, p=P, seed=3):
    st = QueryStream(n=n, p=p, batch=b, nnz=10, seed=seed)
    return (st.dictionary(np.float32),
            st.host_batch(0)["y"].astype(np.float32))


def _lam_max(X, y):
    return float(np.abs(X.T.astype(np.float64) @ y).max())


def _inside_grids(X, Y, num=K):
    """Per-query grids strictly inside (0, λ_max): the λ_max endpoint
    flips on the last bit of λ_max."""
    return np.stack([np.linspace(0.95, 0.05, num) * _lam_max(X, y)
                     for y in Y])


def _cfg(strategy="fista", tol=TOL, **screen):
    return PathConfig(screen=ScreenSpec(**screen),
                      solve=SolveSpec(strategy=strategy, tol=tol))


# ---------------------------------------------------------------------------
# the query stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("corr", [0.0, 0.5])
def test_query_stream_draws_the_references_arrays(corr):
    kw = dict(n=30, p=70, batch=4, nnz=5, corr=corr, sigma=0.2, seed=11)
    st, js = QueryStream(**kw), JStream(**kw)
    np.testing.assert_array_equal(st.dictionary(), js.dictionary())
    np.testing.assert_array_equal(st.dictionary(np.float32),
                                  js.dictionary(np.float32))
    for step, shard, shards in ((0, 0, 1), (3, 1, 2)):
        a = st.host_batch(step, shard, shards)
        b = js.host_batch(step, shard, shards)
        assert a.keys() == b.keys() and a["y"].shape == (4 // shards, 30)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    got, want = list(st.queries(11)), list(js.queries(11))
    assert len(got) == len(want) == 11
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert st.dictionary().flags.writeable          # a fresh copy


# ---------------------------------------------------------------------------
# batched screens == per-query screens, bit for bit
# ---------------------------------------------------------------------------

def _warm_state(X, Y, eng, frac=0.6):
    """A batched sequential state from a rough solution at frac·λ_max (the
    same for the batch and the single engines)."""
    lam = frac * np.asarray(eng.lam_max)
    Xt = torch.from_numpy(X)
    beta = torch.zeros((Y.shape[0], X.shape[1]))
    for b in range(Y.shape[0]):
        res = SolverEngine(torch.from_numpy(Y[b]), tol=1e-4).solve(
            Xt, float(lam[b]))
        beta[b] = res.beta
    return beta, lam


@pytest.mark.parametrize("batch", [B, 12])
@pytest.mark.parametrize("rule", RULES)
def test_batched_screens_match_per_query_screens(rule, batch):
    X, Y = _stream(b=batch)
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    geom = DictionaryGeometry(Xt)
    eng = ScreeningEngine(Xt, Yt, geometry=geom)
    singles = [ScreeningEngine(Xt, Yt[b].clone(), geometry=geom)
               for b in range(batch)]
    lam_max = np.asarray(eng.lam_max)
    assert lam_max.shape == (batch,)
    assert [s.lam_max for s in singles] == list(lam_max)
    beta, lam_prev = _warm_state(X, Y, eng)
    fitted = beta @ Xt.T
    states = [(eng.state_at_lambda_max(),
               [s.state_at_lambda_max() for s in singles]),
              (eng.make_state(beta, lam_prev, fitted=fitted),
               [s.make_state(beta[b], float(lam_prev[b]),
                             fitted=fitted[b].clone())
                for b, s in enumerate(singles)])]
    lam = (0.5 * lam_max).astype(np.float32)     # (B,) f32, as a server's
    for state, per_query in states:
        got = eng.screen(lam, state, rule).numpy()
        assert got.shape == (batch, P)
        assert eng.last_x_passes == engine_x_passes(rule)
        for b in range(batch):
            want = singles[b].screen(float(lam[b]), per_query[b], rule)
            np.testing.assert_array_equal(got[b], want.numpy(),
                                          err_msg=f"{rule} query {b}")


# ---------------------------------------------------------------------------
# the batched path against B single runs of the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["fista", "cd"])
def test_batched_path_reproduces_single_runs(strategy):
    X, Y = _stream()
    grids = _inside_grids(X, Y)
    sess = LassoSession.fit(X, device="cpu")
    cfg = _cfg(strategy)
    res = sess.path(Y, grids, config=cfg)
    assert res.betas.shape == res.masks.shape == (B, K, P)
    assert res.query_converged.shape == (B,)
    # matvec CD's last steps (bucket > n) sit at the f32 gap's noise at
    # tol 1e-6 here, in the single runs as much: convergence is FISTA's
    assert res.query_converged.all() or strategy == "cd"
    for b in range(B):
        one = sess.path(Y[b], grids[b], config=cfg)
        np.testing.assert_array_equal(res.masks[b], one.masks[0],
                                      err_msg=f"query {b}")
        err = float(np.abs(res.betas[b] - one.betas[0]).max())
        assert err <= beta_err_tol(Y[b], TOL), (b, err)
    screened = [s for s in res.stats if s.screen_backend]
    assert screened and all(s.batch_size == B for s in screened)
    assert all(s.x_passes == 1 and s.x_passes_per_query == 1 / B
               for s in screened)
    if strategy == "cd":         # every bucket ≤ min(n, 1024)? Gram CD
        assert all(s.gram_step_frac == (1.0 if s.bucket <= N else 0.0)
                   for s in screened)
    # the union bucket holds every query's survivors
    for k, s in enumerate(res.stats):
        assert s.n_kept == int((~res.masks[:, k]).any(axis=0).sum())
        assert s.n_discarded == int(res.masks[:, k].all(axis=0).sum())


# ---------------------------------------------------------------------------
# the batched path against the reference's batched session
# ---------------------------------------------------------------------------

def _reference_scores(X, Y, res_j):
    """Per query and step, the reference's EDPP scores |Xᵀc| + ρ‖x_j‖
    (float64 on its float32 centre) from its own previous solution, or
    None where the step is trivial for the query."""
    out = {}
    col_norms = np.linalg.norm(X.astype(np.float64), axis=0)
    for b in range(Y.shape[0]):
        eng = JEngine(jnp.asarray(X), jnp.asarray(Y[b]), backend="jnp")
        state = eng.state_at_lambda_max()
        for k, lam in enumerate(res_j.lambdas[b]):
            if lam >= eng.lam_max:
                continue
            sp = jscr.SPHERE_RULES["edpp"](jnp.asarray(Y[b]), lam, state)
            out[b, k] = (np.abs(X.T.astype(np.float64)
                                @ np.asarray(sp.centre))
                         + float(sp.rho) * col_norms)
            beta = res_j.betas[b, k].astype(np.float32)
            state = eng.make_state(jnp.asarray(beta), lam,
                                   fitted=jnp.asarray(X @ beta))
    return out


GRIDS = {
    "per_query": lambda X, Y: _inside_grids(X, Y),
    "shared": lambda X, Y: np.linspace(0.95, 0.05, K) * _lam_max(X, Y[0]),
    "own": lambda X, Y: None,
}


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("strategy", ["fista", "cd"])
def test_batched_path_matches_reference_batched_session(strategy, grid):
    X, Y = _stream(seed=4)
    lambdas = GRIDS[grid](X, Y)
    kw = dict(num_lambdas=K, hi_frac=0.95)
    res_j = JSession.fit(X, config=JConfig(
        solve=JSolve(strategy=strategy, tol=TOL))).path(
        jnp.asarray(Y), lambdas, **kw)
    res_t = LassoSession.fit(X, device="cpu", config=_cfg(strategy)).path(
        Y, lambdas, **kw)
    np.testing.assert_allclose(res_t.lambdas, res_j.lambdas, rtol=LMAX_RTOL,
                               atol=0)
    scores = _reference_scores(X, Y, res_j)
    diff = res_t.masks != res_j.masks
    band_cols = 0
    for b in range(B):
        for k in range(K):
            if (b, k) in scores:
                band = np.abs(scores[b, k] - (1.0 - 1e-6)) <= BAND
                band_cols += int(band.sum())
                assert not (diff[b, k] & ~band).any(), (b, k)
            else:
                assert not diff[b, k].any(), (b, k)
        err = float(np.abs(res_t.betas[b] - res_j.betas[b]).max())
        assert err <= beta_err_tol(Y[b], TOL), (b, err)
    print(f"{strategy}/{grid}: {band_cols} query-step-columns in the band; "
          f"masks differ at {int(diff.sum())}")
    np.testing.assert_array_equal(res_t.query_converged,
                                  res_j.query_converged)
    for k, (s_t, s_j) in enumerate(zip(res_t.stats, res_j.stats)):
        assert (s_t.batch_size, s_t.x_passes_per_query) == \
            (s_j.batch_size, s_j.x_passes_per_query), k
        if not diff[:, k].any():
            assert (s_t.bucket, s_t.n_discarded) == (s_j.bucket,
                                                     s_j.n_discarded), k


# ---------------------------------------------------------------------------
# the solver's batch contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["fista", "cd"])
def test_converged_query_beta_untouched_by_more_iterations(strategy):
    X, Y = _stream(b=4, seed=7)
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    fracs = np.array([0.9, 0.8, 0.7, 0.05])   # three easy, one hard
    lam = fracs * np.array([_lam_max(X, y) for y in Y])
    runs = [SolverEngine(Yt, solver=strategy, tol=1e-7, max_iter=m)
            .solve_batched(Xt, lam) for m in (300, 5000)]
    short, long = runs
    assert short.converged[:3].all(), "easy queries converge early"
    assert not short.converged.all(), "the hard query still iterates"
    for b in np.flatnonzero(short.converged):
        np.testing.assert_array_equal(short.beta[b].numpy(),
                                      long.beta[b].numpy(), f"query {b}")
        assert long.iters[b] == short.iters[b]
    assert short.iters[:3].max() < short.iters[3]
    assert long.iters[3] > short.iters[3]


def test_per_query_trivial_region_on_shared_grid():
    X, Y = _stream(b=2, seed=9)
    Y = np.stack([Y[0], 0.3 * Y[1]]).astype(np.float32)
    lmax0, lmax1 = _lam_max(X, Y[0]), _lam_max(X, Y[1])
    assert lmax1 < 0.5 * lmax0
    grid = np.linspace(0.95, 0.05, 6) * lmax0
    sess = LassoSession.fit(X, device="cpu")
    res = sess.path(Y, grid, config=_cfg())
    dead = grid >= lmax1
    assert dead.any() and not dead.all()
    assert (res.betas[1, dead] == 0.0).all() and res.masks[1, dead].all()
    assert res.query_converged.all()
    for b in range(2):
        one = sess.path(Y[b], grid, config=_cfg())
        np.testing.assert_array_equal(res.masks[b], one.masks[0])
        assert np.abs(res.betas[b] - one.betas[0]).max() \
            <= beta_err_tol(Y[b], TOL)


def test_own_grids_and_the_query_view():
    X, Y = _stream(b=3, seed=11)
    res = LassoSession.fit(X, device="cpu").path(
        Y, num_lambdas=5, config=_cfg())
    for b in range(3):
        np.testing.assert_allclose(res.lambdas[b],
                                   np.linspace(1.0, 0.05, 5)
                                   * _lam_max(X, Y[b]), rtol=1e-6)
        view = res.query(b)
        assert view.betas.shape == (5, P) and view.masks.shape == (5, P)
        assert view.query_converged.shape == (1,)
    with pytest.raises(ValueError, match="query"):
        res.squeeze()
    stuck = LassoSession.fit(X, device="cpu").path(
        Y, _inside_grids(X, Y, 5), config=PathConfig(solve=SolveSpec(
            tol=1e-12, max_iter=2)))
    assert not stuck.query_converged.any() and np.isfinite(stuck.betas).all()


def test_b1_batch_reroutes_to_the_single_query_driver(monkeypatch):
    X, Y = _stream(b=1, seed=17)
    grids = _inside_grids(X, Y, 5)
    calls = []
    orig = LassoSession._lasso_path

    def spy(self, y, lambdas, cfg, grid_kw):
        calls.append(tuple(y.shape))
        return orig(self, y, lambdas, cfg, grid_kw)

    monkeypatch.setattr(LassoSession, "_lasso_path", spy)
    res_b = LassoSession.fit(X, device="cpu").path(Y, grids, config=_cfg())
    assert calls == [(N,)]
    assert res_b.batched and res_b.batch == 1
    assert res_b.query_converged.shape == (1,)
    res_1 = LassoSession.fit(X, device="cpu").path(Y[0], grids[0],
                                                   config=_cfg())
    np.testing.assert_array_equal(res_b.masks, res_1.masks)
    np.testing.assert_array_equal(res_b.betas, res_1.betas)


def test_a_strategy_without_a_batched_twin_runs_per_query():
    """``register_solver`` without ``batched``: each query solves alone on
    the union bucket with its own columns (the rest zeroed), the
    eigenvector cache popped between queries; the path still matches B
    single runs, and the passes add up over the queries."""
    X, Y = _stream(b=4, seed=21)
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    lam = np.array([0.5 * _lam_max(X, y) for y in Y])
    register_solver("fista_alone", SOLVERS["fista"])
    try:
        eng = SolverEngine(Yt, solver="fista_alone", tol=TOL, max_iter=20000)
        res = eng.solve_batched(Xt, lam)
        native = SolverEngine(Yt, solver="fista", tol=TOL,
                              max_iter=20000).solve_batched(Xt, lam)
        assert res.beta.shape == native.beta.shape == (4, P)
        for b in range(4):
            assert float((res.beta[b] - native.beta[b]).abs().max()) \
                <= beta_err_tol(Y[b], TOL)
        assert res.converged.all()
        assert eng.last_x_passes == sum(2.0 * i for i in res.iters) \
            + 2.0 * res.gap_checks
        grids = _inside_grids(X, Y, 6)
        cfg = _cfg("fista_alone", paranoid=True)
        sess = LassoSession.fit(X, device="cpu")
        res_b = sess.path(Y, grids, config=cfg)
        assert np.isfinite(res_b.betas).all()
        for b in range(4):
            one = sess.path(Y[b], grids[b], config=cfg)
            np.testing.assert_array_equal(res_b.masks[b], one.masks[0])
            assert np.abs(res_b.betas[b] - one.betas[0]).max() \
                <= beta_err_tol(Y[b], TOL)
        register_solver("fista_alone", SOLVERS["fista"],
                        batched=lambda *a: pytest.fail("not this one"))
        register_solver("fista_alone", SOLVERS["fista"])
        SolverEngine(Yt, solver="fista_alone", tol=TOL).solve_batched(Xt,
                                                                      lam)
    finally:
        register_solver("fista_alone", SOLVERS["fista"])
        SOLVERS.pop("fista_alone", None)


def test_batched_queries_are_validated():
    X, Y = _stream(b=2)
    sess = LassoSession.fit(X, device="cpu")
    with pytest.raises(ValueError, match=r"\(n,\) or \(B, n\)"):
        sess.path(Y[None])
    with pytest.raises(ValueError, match="dictionary rows"):
        sess.path(Y[:, :-1])
    with pytest.raises(ValueError, match="decreasing"):
        sess.path(Y, np.linspace(0.1, 1.0, 4) * _lam_max(X, Y[0]))
    with pytest.raises(ValueError, match="batched engine"):
        SolverEngine(torch.from_numpy(Y[0])).solve_batched(
            torch.from_numpy(X), [0.1])


# ---------------------------------------------------------------------------
# group batches
# ---------------------------------------------------------------------------

def test_group_batch_matches_reference_and_single_runs():
    m = 5
    X, y0, _ = group_lasso_problem(40, 200, m, active_groups=4, seed=3,
                                   dtype=np.float32)
    Y = np.stack([y0] + [group_lasso_problem(40, 200, m, active_groups=4,
                                             seed=s, dtype=np.float32)[1]
                         for s in (4, 5)]).astype(np.float32)
    kw = dict(num_lambdas=K, hi_frac=0.95)
    cfg = PathConfig(solve=SolveSpec(tol=TOL))
    sess = LassoSession.fit(X, groups=m, device="cpu", config=cfg)
    res = sess.path(Y, **kw)
    res_j = JSession.fit(X, groups=m, config=JConfig(
        solve=JSolve(tol=TOL))).path(jnp.asarray(Y), **kw)
    assert res.betas.shape == (3, K, 200) and res.masks.shape == (3, K, 40)
    np.testing.assert_allclose(res.lambdas, res_j.lambdas, rtol=LMAX_RTOL)
    np.testing.assert_array_equal(res.masks, res_j.masks)
    np.testing.assert_array_equal(res.query_converged, res_j.query_converged)
    for b in range(3):
        assert np.abs(res.betas[b] - res_j.betas[b]).max() \
            <= beta_err_tol(Y[b], TOL)
        one = sess.path(Y[b], **kw)
        np.testing.assert_array_equal(res.masks[b], one.masks[0])
        assert np.abs(res.betas[b] - one.betas[0]).max() \
            <= beta_err_tol(Y[b], TOL)
    for s_t, s_j in zip(res.stats, res_j.stats):
        assert s_t.batch_size == s_j.batch_size == 3
        assert (s_t.x_passes, s_t.n_discarded, s_t.bucket) == \
            (s_j.x_passes, s_j.n_discarded, s_j.bucket)
        assert s_t.x_passes_per_query == s_t.x_passes / 3
