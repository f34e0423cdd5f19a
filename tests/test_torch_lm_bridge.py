"""The FFN-pruning bridge (``examples/prune_ffn_torch.py``) on the CPU:
layer 0's FFN activations H of a tiny trained LM, pruned along a group-
Lasso path over neurons (m = 1) with group-EDPP screening, held against
the reference's ``group_lasso_path`` on the same H and y.

With ``GroupPathConfig`` (a group strategy) the port's shim fits a
group session at m = 1 (the group pass ``group_screen_scores`` and
``group_fista``); the reference's fits a plain session there (its fit's
``edpp_screen_scores`` and one ``screen_matvec`` an EDPP screen, solved
by ``group_fista``). For groups of one column both are the Lasso and
group EDPP (Cor. 21) is EDPP, so: the λ grids equal; masks equal outside the ±1e-4 band of the
threshold of the reference's own group scores at each step (counted);
n_discarded equal on steps without a flip; β within ``beta_err_tol``.
"""

import importlib.util
import os
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from benchmarks.common import beta_err_tol
from repro.core import GroupPathConfig as JGroupPathConfig
from repro.core import group_lambda_max as j_group_lambda_max
from repro.core import group_lasso_path as j_group_lasso_path
from repro.core import group_screening as jgs
from repro.core import lambda_grid as j_lambda_grid
from repro.core.engine import GroupScreeningEngine as JGroupEngine
from repro_torch.kernels import ops

BAND = 1e-4
TOL = 1e-6
EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "prune_ffn_torch.py")


def _example():
    spec = importlib.util.spec_from_file_location("prune_ffn_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bridge():
    """H and y of a tiny LM trained 8 steps (d_ff 96, 128 probe tokens)."""
    ex = _example()
    from repro_torch.configs.common import dense_lm
    from repro_torch.data import SyntheticLM, to_device
    from repro_torch.optim import adamw
    from repro_torch.train import steps as ST
    cfg = dense_lm("prunable-tiny", n_layers=2, d_model=32, n_heads=4,
                   n_kv_heads=4, d_head=8, d_ff=96, vocab=300)
    tc = ST.TrainConfig(opt=adamw.OptConfig(lr=3e-3, warmup_steps=2,
                                            total_steps=20))
    state, _ = ST.init_state(0, cfg, tc, device="cpu")
    src = SyntheticLM(vocab=cfg.vocab, seq=32, global_batch=4)
    step = ST.make_train_step(cfg, tc)
    for i in range(8):
        state, _ = step(state, to_device(src.host_batch(i), "cpu"))
    tokens = to_device(src.host_batch(99), "cpu")["tokens"]
    H, y = ex.ffn_regression(state.params, tokens)
    return ex, H, y


def _reference_scores(H, y, res_j):
    """Per step, the reference's group scores (m = 1) and threshold from
    its own previous solution, in float64 on its float32 centre."""
    eng = JGroupEngine(jnp.asarray(H), jnp.asarray(y), 1, backend="jnp")
    spec = np.asarray(eng.spec_norms)
    state, out = eng.state_at_lambda_max(), {}
    for k, lam in enumerate(res_j.lambdas):
        if lam >= eng.lam_max:
            continue
        vp = np.asarray(jgs.group_v2_perp(jnp.asarray(y), lam, state))
        centre = np.asarray(state.theta) + 0.5 * vp
        thresh = 1.0 - 0.5 * np.linalg.norm(vp) * spec - 1e-6
        out[k] = (np.abs(H.T.astype(np.float64) @ centre), thresh)
        beta = res_j.betas[k].astype(np.float32)
        state = eng.make_state(jnp.asarray(beta), lam,
                               fitted=jnp.asarray(H @ beta))
    return out


def test_ffn_activations_are_the_reference_recipe(bridge):
    ex, H, y = bridge
    assert H.shape == (128, 96) and y.shape == (128,)
    assert H.dtype == torch.float32 and torch.isfinite(H).all()
    # y is the target pooled by its per-output population std
    assert float(torch.linalg.norm(y)) > 0


def test_bridge_matches_reference_group_lasso_path(bridge):
    ex, H, y = bridge
    Hn, yn = H.numpy(), y.numpy()
    lmax_j = float(j_group_lambda_max(jnp.asarray(Hn), jnp.asarray(yn), 1))
    grid_j = j_lambda_grid(lmax_j, num=20, lo_frac=0.02)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        res_j = j_group_lasso_path(Hn, yn, 1, grid_j, JGroupPathConfig(
            rule="edpp", solver_tol=TOL))
        ops.reset_counts()
        grid, lmax, res_t = ex.prune_path(H, y, solver_tol=TOL,
                                          device="cpu")
    assert ops.plain_counts()["group_screen_scores"] > 0   # the group pass
    np.testing.assert_allclose(lmax, lmax_j, rtol=2 ** -22)
    np.testing.assert_allclose(grid, grid_j, rtol=2 ** -22, atol=0)
    assert res_t.masks.shape == res_j.masks.shape == (20, 96)
    scores = _reference_scores(Hn, yn, res_j)
    band_cols = flips = 0
    for k, (s_j, s_t) in enumerate(zip(res_j.stats, res_t.stats)):
        diff = res_j.masks[k] != res_t.masks[k]
        if k in scores:
            sc, th = scores[k]
            band = np.abs(sc - th) <= BAND
            band_cols += int(band.sum())
            assert not (diff & ~band).any(), f"step {k}: outside the band"
        else:
            assert not diff.any(), k
        flips += int(diff.sum())
        if not diff.any():
            assert s_t.n_discarded == s_j.n_discarded, k
    err = float(np.abs(res_t.betas - res_j.betas).max())
    print(f"bridge: {flips} mask flips, {band_cols} step-columns in the "
          f"band; max|Δβ| {err:.3g} (tol {beta_err_tol(yn, TOL):.3g}); "
          f"discards {[s.n_discarded for s in res_t.stats]}")
    assert err <= beta_err_tol(yn, TOL)
    lines = ex.table(H, y, grid, lmax, res_t)
    assert len(lines) == 1 + len(ex.ROWS)


def test_group_config_at_m1_fits_a_group_session_plain_config_does_not():
    """At ``groups=1`` the session's kind comes from the config: a group
    strategy (``GroupPathConfig``, as the bridge passes it) with a rule
    the group screen serves fits a group session of one-column groups; a
    plain config, a rule outside the group rules or a bf16 screen, or no
    ``groups=``, the plain Lasso, as in the reference."""
    from repro_torch import LassoSession
    from repro_torch.core import GroupPathConfig
    rng = np.random.default_rng(0)
    X = rng.standard_normal((30, 40)).astype(np.float32)
    for groups in (None, 1):
        sess = LassoSession.fit(X, groups=groups, device="cpu")
        assert not sess.grouped and type(sess.geometry).__name__ == \
            "DictionaryGeometry"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        g = LassoSession.fit(X, groups=1, device="cpu",
                             config=GroupPathConfig(rule="edpp"))
        assert g.grouped and type(g.geometry).__name__ == \
            "GroupDictionaryGeometry"
        for kw in (dict(rule="gap"), dict(screen_dtype="bfloat16")):
            p = LassoSession.fit(X, groups=1, device="cpu",
                                 config=GroupPathConfig(**kw))
            assert not p.grouped and type(p.geometry).__name__ == \
                "DictionaryGeometry"
        with pytest.raises(ValueError, match="solves the group"):
            LassoSession.fit(X, device="cpu",
                             config=GroupPathConfig(rule="edpp"))


@pytest.mark.parametrize("rule, screen_dtype", [
    ("dome", "float32"), ("gap", "float32"), ("edpp_cut", "float32"),
    ("edpp", "bfloat16")])
def test_group_lasso_path_m1_with_a_plain_config_is_the_plain_lasso(
        rule, screen_dtype):
    """``group_lasso_path(X, y, 1, grid, cfg)`` with a plain config takes
    every Lasso rule and the bf16 screen, as the reference's shim does:
    it is the plain session's path bit for bit, and against the
    reference's shim the λ grid is equal, no column the port discards is
    active in the reference's solution (|β| > 1e-6), the masks differ at
    ≤ 1 % of the step-columns (counted), and β is within
    ``beta_err_tol``."""
    from repro.core import PathConfig as JConfig
    from repro.data.pipeline import lasso_problem
    from repro_torch import LassoSession, PathConfig
    from repro_torch.core import group_lasso_path
    X, y, _ = lasso_problem(50, 400, nnz=10, seed=11, dtype=np.float32)
    grid = np.linspace(0.95, 0.1, 12) * float(np.abs(X.T @ y).max())
    kw = dict(rule=rule, screen_dtype=screen_dtype, solver_tol=TOL)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        res_j = j_group_lasso_path(X, y, 1, grid, JConfig(**kw))
        ops.reset_counts()
        res_t = group_lasso_path(X, y, 1, grid, PathConfig(**kw),
                                 device="cpu")
    assert ops.plain_counts()["group_screen_scores"] == 0
    want = LassoSession.fit(X, config=PathConfig(**kw), device="cpu").path(
        y, grid).squeeze()
    np.testing.assert_array_equal(res_t.masks, want.masks)
    np.testing.assert_array_equal(res_t.betas, want.betas)
    np.testing.assert_allclose(res_t.lambdas, res_j.lambdas,
                               rtol=2 ** -22, atol=0)
    assert res_t.masks.shape == res_j.masks.shape == (12, 400)
    assert not (res_t.masks & (np.abs(res_j.betas) > 1e-6)).any()
    flips = int((res_t.masks != res_j.masks).sum())
    err = float(np.abs(res_t.betas - res_j.betas).max())
    print(f"{rule}/{screen_dtype}: {flips} mask flips of "
          f"{res_t.masks.size}; discards "
          f"{[int(k.sum()) for k in res_t.masks]} vs "
          f"{[int(k.sum()) for k in res_j.masks]}; max|Δβ| {err:.3g}")
    assert flips <= 0.01 * res_t.masks.size
    assert err <= beta_err_tol(y, TOL)


# GroupPathConfig at m = 1 outside the group screen's reach: the port
# raised here until it fitted the plain Lasso, as the reference does
M1_CASES = {"dome": dict(rule="dome"), "gap": dict(rule="gap"),
            "bf16_screen": dict(screen_dtype="bfloat16")}


@pytest.mark.parametrize("case", list(M1_CASES))
def test_group_lasso_path_m1_with_a_group_config_outside_the_group_rules(
        case):
    """``group_lasso_path(X, y, 1, grid, GroupPathConfig(...))`` with DOME,
    GAP or a bf16 screen runs the plain Lasso solved by ``group_fista``
    (the reference's shim at m = 1), no group pass: against the
    reference's shim the λ grid is equal, the masks equal outside the
    ±1e-4 band of the rule's thresholds from the reference's own previous
    solutions (counted), and β within ``beta_err_tol``."""
    from repro.data.pipeline import lasso_problem
    from repro_torch.core import GroupPathConfig, group_lasso_path
    from test_torch_rules import path_bands
    kw = M1_CASES[case]
    X, y, _ = lasso_problem(40, 120, nnz=5, seed=1, dtype=np.float32)
    lmax = float(np.abs(X.T.astype(np.float64) @ y).max())
    grid = np.linspace(1.0, 0.3, 5) * lmax
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        res_j = j_group_lasso_path(X, y, 1, grid, JGroupPathConfig(
            solver_tol=TOL, **kw))
        ops.reset_counts()
        res_t = group_lasso_path(X, y, 1, grid, GroupPathConfig(
            solver_tol=TOL, **kw), device="cpu")
    assert ops.plain_counts()["group_screen_scores"] == 0
    np.testing.assert_allclose(res_t.lambdas, res_j.lambdas, rtol=2 ** -22,
                               atol=0)
    assert res_t.masks.shape == res_j.masks.shape == (5, 120)
    bands = path_bands(X, y, res_j.lambdas, res_j.betas,
                       kw.get("rule", "edpp"))
    in_band = flips = 0
    for k, band in enumerate(bands):
        diff = res_t.masks[k] != res_j.masks[k]
        flips += int(diff.sum())
        if band is None:
            assert not diff.any(), k
        else:
            in_band += int(band.sum())
            assert not (diff & ~band).any(), (k, "outside the band")
    err = float(np.abs(res_t.betas - res_j.betas).max())
    print(f"{case}: discards {[int(m.sum()) for m in res_t.masks]} vs "
          f"{[int(m.sum()) for m in res_j.masks]}; {flips} mask flips, "
          f"{in_band} step-columns in the band; max|Δβ| {err:.3g}")
    assert err <= beta_err_tol(y, TOL)


def test_group_lasso_path_m1_default_group_config_runs_the_group_pass():
    """The bridge's route is unchanged: ``GroupPathConfig()`` (EDPP, f32)
    at m = 1 is a group session, ``group_screen_scores`` once a screen
    and once for λ̄_max."""
    from repro.data.pipeline import lasso_problem
    from repro_torch.core import GroupPathConfig, group_lasso_path
    X, y, _ = lasso_problem(40, 120, nnz=5, seed=1, dtype=np.float32)
    grid = np.linspace(1.0, 0.3, 5) * float(np.abs(X.T @ y).max())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ops.reset_counts()
        res = group_lasso_path(X, y, 1, grid, GroupPathConfig(
            solver_tol=TOL), device="cpu")
    screens = sum(1 for s in res.stats if s.screen_backend)
    assert screens > 0
    assert ops.plain_counts()["group_screen_scores"] == screens + 1
