"""End to end on the CPU: the port's ``LassoSession`` against the
reference's on the same numpy problems (``repro.data.pipeline``): the
default FISTA path; the other ported Lasso rules (dpp, imp1, imp2,
seq_safe, safe, none) and EDPP's basic and paranoid variants; the ``cd``
strategy; and group paths (``groups=m``) with ``edpp``, ``strong`` and
``none``.

The contract (ROADMAP.md): λ_max agrees to float32 rounding; the λ grids
match with ``hi_frac=0.95`` pinned (the λ = λ_max endpoint flips on the
last bit of λ_max); discard masks are equal except for columns whose
reference score lies within BAND of the threshold — counted and printed,
never hidden; β agrees within ``beta_err_tol(y, 1e-6)``; the pass counts
agree. The reference's f32 path cannot certify the default tol 1e-8, so
parity runs at tol 1e-6.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import LassoSession as JSession
from repro.core import PathConfig as JConfig
from repro.core import ScreeningEngine as JEngine
from repro.core import ScreenSpec as JScreen
from repro.core import SolveSpec as JSolve
from repro.core import group_screening as jgs
from repro.core import screening as jscr
from repro.core.engine import GroupScreeningEngine as JGroupEngine
from repro.data.pipeline import group_lasso_problem, lasso_problem
from repro_torch import (LassoSession, PathConfig, ScreenSpec, SolveSpec,
                         session_from_arrays)

BAND = 1e-4          # score units around the threshold 1 − eps
TOL = 1e-6
GRID = dict(num_lambdas=20, hi_frac=0.95)
SRC = Path(__file__).resolve().parents[1] / "src"


def beta_err_tol(y, solver_tol, kappa=25.0):
    """benchmarks/common.py: two gap-ε solutions differ by ≤ this."""
    y = np.asarray(y, np.float64)
    return kappa * float(np.sqrt(solver_tol * 0.5 * float(y @ y)))


def _carry(js, config):
    """The reference session's fitted state, handed over as numpy."""
    arrays = {"X": np.asarray(js.geometry.X),
              "sumsq": np.asarray(js.geometry.sumsq),
              "eig_cache": {b: np.asarray(v)
                            for b, v in js._eig_cache.items()}}
    return session_from_arrays(arrays, config=config, device="cpu")


def _reference_scores(js, X, y, res_j, rule="edpp", sequential=True):
    """Per step, the reference's sphere scores |Xᵀc| + ρ‖x_j‖ for ``rule``
    and the threshold they are held to, from its own previous solution
    (float64 numpy on its float32 centre): 1 − eps, and 1 − eps/λ for
    basic SAFE (eq. 15's margin at λ scale). The basic variants
    (``sequential=False``) keep the state at λ_max; ``none`` has no
    scores."""
    if rule == "none":
        return {}
    eng = JEngine(jnp.asarray(X), jnp.asarray(y), backend="jnp",
                  geometry=js.geometry)
    lams, betas = res_j.lambdas[0], res_j.betas[0]
    col_norms = np.linalg.norm(X.astype(np.float64), axis=0)
    state, out = eng.state_at_lambda_max(), {}
    for k, lam in enumerate(lams):
        if lam >= eng.lam_max:
            continue
        if rule == "safe":
            sp = jscr.safe_sphere(jnp.asarray(y), lam, eng.lam_max)
            thresh = 1.0 - 1e-6 / lam
        else:
            sp = jscr.SPHERE_RULES[rule](jnp.asarray(y), lam, state)
            thresh = 1.0 - 1e-6
        out[k] = (np.abs(X.T.astype(np.float64) @ np.asarray(sp.centre))
                  + float(sp.rho) * col_norms, thresh)
        if sequential:
            beta = betas[k].astype(np.float32)
            state = eng.make_state(jnp.asarray(beta), lam,
                                   fitted=jnp.asarray(X @ beta))
    return out


def _compare(js, X, y, res_j, res_t, rule="edpp", sequential=True):
    lmax = float(np.abs(X.T.astype(np.float64) @ y).max())
    np.testing.assert_allclose(res_t.lambdas, res_j.lambdas,
                               rtol=2 ** -22, atol=0)
    scores = _reference_scores(js, X, y, res_j, rule, sequential)
    band_cols = 0
    for k, (s_j, s_t) in enumerate(zip(res_j.stats, res_t.stats)):
        m_j, m_t = res_j.masks[0, k], res_t.masks[0, k]
        diff = m_j != m_t
        if k in scores:
            band = np.abs(scores[k][0] - scores[k][1]) <= BAND
            band_cols += int(band.sum())
            assert not (diff & ~band).any(), f"step {k}: outside the band"
        else:
            assert not diff.any()
        assert s_t.x_passes == s_j.x_passes
        if not diff.any():
            assert (s_t.n_discarded, s_t.bucket) == (s_j.n_discarded,
                                                     s_j.bucket), k
    print(f"{X.shape}: λ_max {lmax:.6g}; {band_cols} step-columns in the "
          f"band; masks differ at {int((res_j.masks != res_t.masks).sum())}")
    err = float(np.abs(res_t.betas - res_j.betas).max())
    assert err <= beta_err_tol(y, TOL), err
    assert bool(res_t.query_converged[0]) == bool(res_j.query_converged[0])


@pytest.mark.parametrize("shape", [(50, 400), (100, 1000)])
def test_path_matches_reference_session(shape):
    n, p = shape
    X, y, _ = lasso_problem(n, p, nnz=10, seed=n, dtype=np.float32)
    js = JSession.fit(X, config=JConfig(solve=JSolve(tol=TOL)))
    # the same numpy start vector per pow-2 bucket in both eig caches
    rng = np.random.default_rng(p)
    for b in {min(1 << k, p) for k in range(5, p.bit_length() + 1)}:
        js._eig_cache[b] = jnp.asarray(
            rng.standard_normal(b).astype(np.float32))
    ts = _carry(js, PathConfig(solve=SolveSpec(tol=TOL)))
    assert ts.fit_passes == 0 and set(ts._eig_cache) == set(js._eig_cache)
    # warm arm: both solvers start from the carried eigenvectors
    res_j = js.path(jnp.asarray(y), **GRID)
    res_t = ts.path(y, **GRID)
    _compare(js, X, y, res_j, res_t)
    assert ts.query_passes == 1 and ts.fit_passes == 0
    if shape == (100, 1000):
        # cold arm: each package's own seeded power iteration
        js.reset_solver_cache()
        ts.reset_solver_cache()
        assert not ts._eig_cache
        _compare(js, X, y, js.path(jnp.asarray(y), **GRID),
                 ts.path(y, **GRID))


@pytest.mark.parametrize("rule, sequential, paranoid", [
    ("dpp", True, False), ("imp1", True, False), ("imp2", True, False),
    ("seq_safe", True, False), ("safe", True, False), ("none", True, False),
    ("edpp", False, False), ("edpp", True, True)])
def test_other_rules_match_reference_session(rule, sequential, paranoid):
    """The other ported Lasso rules end to end, and EDPP's basic variant
    (the state kept at λ_max) and its paranoid KKT backstop: the same
    contract as the default path against a reference session carried
    over by ``session_from_arrays``, masks held to each rule's own sphere
    and threshold."""
    X, y, _ = lasso_problem(50, 400, nnz=10, seed=60, dtype=np.float32)
    js = JSession.fit(X, config=JConfig(
        screen=JScreen(rule=rule, sequential=sequential, paranoid=paranoid),
        solve=JSolve(tol=TOL)))
    ts = _carry(js, PathConfig(
        screen=ScreenSpec(rule=rule, sequential=sequential,
                          paranoid=paranoid), solve=SolveSpec(tol=TOL)))
    res_j = js.path(jnp.asarray(y), **GRID)
    res_t = ts.path(y, **GRID)
    _compare(js, X, y, res_j, res_t, rule, sequential)
    assert [s.kkt_rounds for s in res_t.stats] \
        == [s.kkt_rounds for s in res_j.stats]
    live = [s for s in res_t.stats if s.screen_backend]
    assert all(s.x_passes == (0 if rule == "none" else 1) for s in live)
    if rule == "none":
        assert not res_t.masks.any()


def test_default_tol_stops_on_float32_noise_in_both_packages():
    """At tol 1e-8 the f32 duality gap is below its own rounding noise, so
    which steps stop at ``max_iter`` depends on each package's summation
    order (they need not agree; the counts are printed), while β agrees
    far inside ``beta_err_tol(y, 1e-8)``."""
    X, y, _ = lasso_problem(50, 400, nnz=10, seed=50, dtype=np.float32)
    kw = dict(num_lambdas=20, hi_frac=0.95)
    res_j = JSession.fit(X, config=JConfig(max_iter=1000)).path(
        jnp.asarray(y), **kw)
    res_t = LassoSession.fit(X, device="cpu", config=PathConfig(
        max_iter=1000)).path(y, **kw)
    at_max = [sum(s.solver_iters >= 1000 for s in r.stats)
              for r in (res_j, res_t)]
    print(f"steps at max_iter: reference {at_max[0]}, port {at_max[1]}")
    assert min(at_max) > 0
    assert np.abs(res_t.betas - res_j.betas).max() <= beta_err_tol(y, 1e-8)


def test_session_fits_once_and_counts_passes():
    X, y, _ = lasso_problem(40, 300, nnz=6, seed=1, dtype=np.float32)
    sess = LassoSession.fit(X, device="cpu",
                            config=PathConfig(solve=SolveSpec(tol=TOL)))
    assert sess.fit_passes == 1 and sess.backend_name == "torch"
    res = sess.path(y, **GRID)
    res2 = sess.path(torch.from_numpy(y), **GRID,
                     config=PathConfig(paranoid=True, solver_tol=TOL))
    assert sess.fit_passes == 1 and sess.query_passes == 2
    live = [s for s in res.stats if s.screen_backend]
    assert live and all(s.x_passes == 1 for s in live)
    assert all(s.kkt_rounds == 0 for s in res2.stats)   # EDPP is safe
    np.testing.assert_array_equal(res.masks, res2.masks)
    assert res.betas.shape == (1, 20, 300) and res.squeeze().betas.shape \
        == (20, 300)
    assert np.isfinite(res.betas).all() and res.query_converged[0]
    basic = sess.path(y, **GRID, config=PathConfig(sequential=False,
                                                   solver_tol=TOL))
    assert (basic.masks <= res.masks | basic.masks).all()
    assert np.abs(basic.betas - res.betas).max() <= beta_err_tol(y, TOL)


def test_edpp_discards_nothing_the_unscreened_path_keeps():
    """The smoke's exactness phase at a small size: EDPP against
    ``rule="none"`` on the same session."""
    X, y, _ = lasso_problem(60, 500, nnz=8, seed=2, dtype=np.float32)
    sess = LassoSession.fit(X, device="cpu")
    arms = {}
    for rule in ("edpp", "none"):
        sess.reset_solver_cache()
        arms[rule] = sess.path(y, **GRID, config=PathConfig(
            screen=ScreenSpec(rule=rule), solve=SolveSpec(tol=TOL)))
    b_e, b_n = arms["edpp"].betas[0], arms["none"].betas[0]
    assert np.abs(b_e - b_n).max() <= beta_err_tol(y, TOL)
    kept_needed = np.abs(b_n) > 1e-6 * np.abs(b_n).max()
    assert not (arms["edpp"].masks[0] & kept_needed).any()
    assert arms["edpp"].masks[0].mean() > 0.5
    assert not arms["none"].masks[0, 1:].any()


def test_fit_runs_on_the_card_unless_asked_otherwise():
    X = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32)
    if torch.cuda.is_available():
        assert LassoSession.fit(X).X.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LassoSession.fit(X)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            session_from_arrays({"X": X, "sumsq": (X * X).sum(0)})
    assert LassoSession.fit(X, device="cpu").X.device.type == "cpu"


# What a session still refuses: a group session refuses ``update`` as the
# reference does (no ROADMAP item brings it: ``item`` is then the
# message). The bf16 screen and solve run on plain and mesh sessions
# (tests/test_torch_bf16_solve.py, tests/test_torch_bf16_mesh.py),
# ``update`` on plain and mesh sessions (tests/test_torch_update.py) and
# group sessions on a mesh (tests/test_torch_group_mesh.py, and the cases
# of test_group_mesh_sessions_take_what_group_sessions_take below).
_GROUP_UPDATE = "plain-Lasso only"


@pytest.mark.parametrize("what, call, item", [
    ("update_add", lambda s, y: LassoSession.fit(
        s.X, groups=2, device="cpu").update(add=s.X[:, :2]), _GROUP_UPDATE),
    ("update", lambda s, y: LassoSession.fit(
        s.X, groups=2, device="cpu").update(drop=[0]), _GROUP_UPDATE),
])
def test_later_slices_raise_naming_their_roadmap_item(what, call, item):
    X, y, _ = lasso_problem(10, 20, nnz=2, seed=3, dtype=np.float32)
    sess = LassoSession.fit(X, device="cpu")
    match = (item if isinstance(item, str)
             else f"ROADMAP.md queue 1 item {item} ")
    with pytest.raises(NotImplementedError, match=match):
        call(sess, y)


# The cases a group mesh session refused (ROADMAP.md item 13) until group
# sessions ran on a mesh: each now does what an unsharded group session
# does with the same config, on a one-rank gloo mesh.
_GROUP_MESH_CASES = {
    "group_mesh": PathConfig(solve=SolveSpec(tol=TOL)),
    "solve_bf16_fista": PathConfig(solve=SolveSpec(
        tol=TOL, solve_dtype="bfloat16")),
    "solve_bf16_cd": PathConfig(solve=SolveSpec(
        strategy="cd", tol=TOL, solve_dtype="bfloat16")),
    "mesh_bf16": PathConfig(screen=ScreenSpec(screen_dtype="bfloat16"),
                            solve=SolveSpec(tol=TOL)),
}


@pytest.mark.parametrize("what", list(_GROUP_MESH_CASES))
def test_group_mesh_sessions_take_what_group_sessions_take(what, monkeypatch):
    """``group_mesh``: the path of ``fit(X, groups=2, mesh=)`` is the
    unsharded group session's bit for bit (``backend_name``
    ``"shard:torch"``); ``solve_bf16_fista``: it warns that group_fista
    has no bf16 phase and solves in float32, bit for bit the float32
    mesh path; ``solve_bf16_cd`` (a Lasso strategy) and ``mesh_bf16`` (a
    bf16 group screen): refused with the unsharded group session's
    ``ValueError``."""
    import torch_dist_worker as worker
    from repro_torch.core import solver
    X, y, _ = group_lasso_problem(20, 40, 2, active_groups=3, seed=3,
                                  dtype=np.float32)
    cfg = _GROUP_MESH_CASES[what]
    f32 = _GROUP_MESH_CASES["group_mesh"]
    monkeypatch.setattr(solver, "_BF16_SOLVE_WARNED", set())
    with worker.one_rank() as mesh:
        if what in ("solve_bf16_cd", "mesh_bf16"):
            for kw in ({}, {"mesh": mesh}):
                with pytest.raises(ValueError, match="group sessions"):
                    LassoSession.fit(X, groups=2, device="cpu", config=cfg,
                                     **kw)
            return
        sess = LassoSession.fit(X, groups=2, mesh=mesh, device="cpu",
                                config=f32)
        assert sess.backend_name == "shard:torch" and sess.fit_passes == 1
        res = sess.path(y, **GRID)
        if what == "group_mesh":
            want = LassoSession.fit(X, groups=2, device="cpu",
                                    config=f32).path(y, **GRID)
        else:
            sess.reset_solver_cache()
            want = res
            with pytest.warns(RuntimeWarning, match="group_fista"):
                res = sess.path(y, **GRID, config=cfg)
            live = [s for s in res.stats if s.screen_backend]
            assert live and all(s.solve_dtype_effective == "float32"
                                and s.solver_lo_iters == 0 for s in live)
    np.testing.assert_array_equal(res.masks, want.masks)
    np.testing.assert_array_equal(res.betas, want.betas)
    assert [s.bucket for s in res.stats] == [s.bucket for s in want.stats]


def test_config_validation_matches_reference():
    for bad in (dict(rule="bogus"), dict(eps=-1.0), dict(kkt_tol=0.0),
                dict(solver_tol=0.0), dict(max_iter=0),
                dict(gap_check_cadence=0), dict(solver="bogus")):
        with pytest.raises(ValueError):
            JConfig(**bad)
        with pytest.raises(ValueError):
            PathConfig(**bad)
    cfg = PathConfig(rule="dpp", solver_tol=1e-7, bucket_min=64)
    assert (cfg.screen.rule, cfg.solve.tol, cfg.solve.bucket_min) \
        == ("dpp", 1e-7, 64)
    assert PathConfig().solve == SolveSpec() and SolveSpec().tol == 1e-8


def test_package_imports_neither_jax_nor_the_reference():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "for name in ('kernels.group_screen', 'core.group_lasso', "
        "'core.group_screening', 'core.distributed', 'launch.serve_loop', "
        "'launch.serve', 'launch.solve', 'launch.cli', "
        "'checkpoint.checkpoint', 'models.model', 'models.layers', "
        "'optim.adamw', 'train.steps', 'configs', 'runtime.elastic', "
        "'launch.train', 'pshard', 'train.sharding', 'launch.mesh'):\n"
        "    assert 'repro_torch.' + name in sys.modules, name\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert not torch.backends.cuda.matmul."
        "allow_bf16_reduced_precision_reduction\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout) >= 55
    assert repro_torch.LassoSession is LassoSession


def test_cd_path_matches_reference_session():
    """``SolveSpec(strategy="cd")`` end to end: Gram CD through the plain
    sweep on the buckets up to min(n, GRAM_BUCKET_MAX) columns, matvec CD
    above, against the reference's cd session on the same problem."""
    X, y, _ = lasso_problem(50, 400, nnz=10, seed=50, dtype=np.float32)
    js = JSession.fit(X, config=JConfig(solve=JSolve(strategy="cd",
                                                     tol=TOL)))
    ts = _carry(js, PathConfig(solve=SolveSpec(strategy="cd", tol=TOL)))
    res_j = js.path(jnp.asarray(y), **GRID)
    res_t = ts.path(y, **GRID)
    _compare(js, X, y, res_j, res_t)
    grams = [(s_t.gram_step_frac, s_j.gram_step_frac)
             for s_t, s_j in zip(res_t.stats, res_j.stats)]
    assert all(a == b for a, b in grams), grams
    live = [s for s in res_t.stats if s.screen_backend]
    assert any(s.gram_step_frac == 1.0 for s in live)     # G sweeps ran
    assert all(s.solver_backend == "torch" for s in live)
    assert ts.config.solve.resolved_strategy() == "cd"


def _reference_group_scores(js, X, y, res_j, rule):
    """Per step, the reference's group scores and threshold from its own
    previous solution (float64 numpy on its float32 centre)."""
    m = js.groups
    eng = JGroupEngine(jnp.asarray(X), jnp.asarray(y), m, backend="jnp",
                       geometry=js.geometry)
    spec = np.asarray(js.geometry.spec_norms)
    state, out = eng.state_at_lambda_max(), {}
    for k, lam in enumerate(res_j.lambdas[0]):
        if lam >= eng.lam_max:
            continue
        if rule == "edpp":
            vp = np.asarray(jgs.group_v2_perp(jnp.asarray(y), lam, state))
            centre = np.asarray(state.theta) + 0.5 * vp
            thresh = np.sqrt(m) - 0.5 * np.linalg.norm(vp) * spec - 1e-6
        else:
            centre = np.asarray(state.theta) * float(state.lam)
            thresh = np.sqrt(m) * (2 * lam - float(state.lam)) - 1e-6
        scores = np.linalg.norm((X.T.astype(np.float64) @ centre)
                                .reshape(-1, m), axis=1)
        out[k] = (scores, thresh)
        beta = res_j.betas[0, k].astype(np.float32)
        state = eng.make_state(jnp.asarray(beta), lam,
                               fitted=jnp.asarray(X @ beta))
    return out


@pytest.mark.parametrize("rule", ["edpp", "strong", "none"])
def test_group_path_matches_reference_session(rule):
    """Group paths on a reference group session carried over by
    ``session_from_arrays`` (spectral norms and eigenvector cache), and on
    a port fit of its own: λ grids, group masks in band, β within
    ``beta_err_tol``, equal bucket / n_discarded / KKT rounds."""
    m = 5
    X, y, _ = group_lasso_problem(60, 300, m, active_groups=4, seed=7,
                                  dtype=np.float32)
    cfg_j = JConfig(screen=JScreen(rule=rule), solve=JSolve(tol=TOL))
    cfg_t = PathConfig(screen=ScreenSpec(rule=rule), solve=SolveSpec(tol=TOL))
    js = JSession.fit(X, groups=m, config=cfg_j)
    rng = np.random.default_rng(m)
    for b in (16 * m, 32 * m, 300):       # the group buckets, in columns
        js._eig_cache[b] = jnp.asarray(
            rng.standard_normal(b).astype(np.float32))
    eig = {b: np.asarray(v) for b, v in js._eig_cache.items()}
    ts = session_from_arrays(
        {"X": X, "groups": m, "spec_norms": np.asarray(js.geometry.spec_norms),
         "eig_cache": eig}, config=cfg_t, device="cpu")
    assert ts.groups == m and ts.fit_passes == 0
    res_j = js.path(jnp.asarray(y), **GRID)
    res_t = ts.path(y, **GRID)
    assert res_t.masks.shape == res_j.masks.shape == (1, 20, 300 // m)
    np.testing.assert_allclose(res_t.lambdas, res_j.lambdas,
                               rtol=2 ** -22, atol=0)
    scores = (_reference_group_scores(js, X, y, res_j, rule)
              if rule != "none" else {})
    band_groups = 0
    for k, (s_j, s_t) in enumerate(zip(res_j.stats, res_t.stats)):
        diff = res_j.masks[0, k] != res_t.masks[0, k]
        if k in scores:
            sc, th = scores[k]
            band = np.abs(sc - th) <= BAND
            band_groups += int(band.sum())
            assert not (diff & ~band).any(), f"step {k}: outside the band"
        else:
            assert not diff.any(), k
        assert s_t.x_passes == s_j.x_passes
        if not diff.any():
            assert (s_t.n_discarded, s_t.bucket, s_t.kkt_rounds) == \
                (s_j.n_discarded, s_j.bucket, s_j.kkt_rounds), k
    err = float(np.abs(res_t.betas - res_j.betas).max())
    print(f"group {rule}: {band_groups} step-groups in the band; max|Δβ| "
          f"{err:.3g}; kkt rounds {sum(s.kkt_rounds for s in res_t.stats)}")
    assert err <= beta_err_tol(y, TOL)
    assert bool(res_t.query_converged[0]) == bool(res_j.query_converged[0])
    if rule == "edpp":
        # the port's own fit: the same spectral norms, one fit pass
        fresh = LassoSession.fit(X, groups=m, config=cfg_t, device="cpu")
        assert fresh.fit_passes == js.fit_passes == 1
        np.testing.assert_allclose(fresh.geometry.spec_norms,
                                   np.asarray(js.geometry.spec_norms),
                                   rtol=1e-5)
        res_f = fresh.path(y, **GRID)
        assert np.abs(res_f.betas - res_j.betas).max() <= beta_err_tol(y,
                                                                       TOL)
        assert fresh.query_passes == 1


def test_group_sessions_validate_rules_as_the_reference_does():
    X, y, _ = group_lasso_problem(20, 40, 4, active_groups=2, seed=3,
                                  dtype=np.float32)
    for rule in ("dpp", "seq_safe", "safe"):
        with pytest.raises(ValueError, match="group sessions support"):
            JSession.fit(X, groups=4, config=JConfig(rule=rule))
        with pytest.raises(ValueError, match="group sessions support"):
            LassoSession.fit(X, groups=4, device="cpu",
                             config=PathConfig(rule=rule))
    sess = LassoSession.fit(X, groups=4, device="cpu")
    assert sess.config.solve.resolved_strategy(4) == "group_fista"
    with pytest.raises(ValueError, match="group sessions support"):
        sess.path(y, config=PathConfig(rule="imp1"))
    with pytest.raises(ValueError, match="not divisible"):
        LassoSession.fit(X, groups=3, device="cpu")
    with pytest.raises(ValueError, match="groups must be"):
        LassoSession.fit(X, groups=0, device="cpu")
    with pytest.raises(NotImplementedError, match="plain-Lasso only"):
        sess.update(drop=[0])
    with pytest.raises(NotImplementedError, match="plain-Lasso only"):
        JSession.fit(X, groups=4).update(drop=[0])
    for rule in ("edpp", "strong", "none"):
        res = sess.path(y, num_lambdas=5, hi_frac=0.95,
                        config=PathConfig(rule=rule, solver_tol=TOL))
        assert res.masks.shape == (1, 5, 10) and np.isfinite(res.betas).all()
    assert ScreenSpec(rule="strong").rule == "strong"


@pytest.mark.parametrize("groups, strategy", [
    (4, "fista"), (4, "cd"), (None, "group_fista")])
def test_sessions_refuse_the_other_problems_strategy(groups, strategy):
    """A group session solving with a Lasso strategy (or a plain session
    with the group one) would return a wrong β under the right name: the
    session refuses it at fit, at adoption and per call."""
    X, y, _ = group_lasso_problem(20, 40, 4, active_groups=2, seed=3,
                                  dtype=np.float32)
    cfg = PathConfig(solve=SolveSpec(strategy=strategy))
    match = "group sessions solve with" if groups else "solves the group"
    with pytest.raises(ValueError, match=match):
        LassoSession.fit(X, groups=groups, device="cpu", config=cfg)
    arrays = {"X": X, "groups": groups,
              "spec_norms": np.ones(10, np.float32),
              "sumsq": (X * X).sum(0)}
    with pytest.raises(ValueError, match=match):
        session_from_arrays(arrays, config=cfg, device="cpu")
    sess = LassoSession.fit(X, groups=groups, device="cpu")
    with pytest.raises(ValueError, match=match):
        sess.path(y, config=cfg)
