"""The rest of the reference's public ``repro.core`` surface in the port,
on the CPU: every name ``src/repro/core/__init__.py`` imports is
importable from ``repro_torch.core`` (or named in ``NO_COUNTERPART``
with the reason); the one-shot solvers ``fista``, ``cd`` and
``group_fista`` against the reference's on the same numpy inputs; the
deprecated shims bit for bit the session calls they stand for, each
with its ``DeprecationWarning``; ``block_scores`` bit for bit the fused
pass; the backend registry helpers; and the example twins
(``examples/quickstart_torch.py``, ``examples/distributed_screening_
torch.py``) run with ``--quick``.

Tolerances: the one-shot solvers' β within ``beta_err_tol(y, 1e-6)``
(two solutions at the relative gap 1e-6 differ by at most that), their
iteration counts printed; with the reference's Lipschitz constant passed
to both, FISTA's iteration counts equal. Everything else is bit for bit.
"""

import ast
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.data.pipeline import group_lasso_problem, lasso_problem
from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
from repro_torch.kernels import ops, ref

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-6
GRID = dict(num_lambdas=10, hi_frac=0.95)

#: Names of ``repro.core`` with no counterpart in ``repro_torch.core``,
#: each with the reason. Empty: every name has one.
NO_COUNTERPART: dict[str, str] = {}


def _reference_names() -> list[str]:
    tree = ast.parse((ROOT / "src/repro/core/__init__.py").read_text())
    return [a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


NAMES = _reference_names()


def beta_err_tol(y, solver_tol, kappa=25.0):
    """benchmarks/common.py: two gap-ε solutions differ by ≤ this."""
    y = np.asarray(y, np.float64)
    return kappa * float(np.sqrt(solver_tol * 0.5 * float(y @ y)))


def test_the_reference_exports_what_this_file_lists():
    assert len(NAMES) == len(set(NAMES)) == 103
    assert not set(NO_COUNTERPART) - set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_every_reference_core_name_imports_from_the_port(name):
    if name in NO_COUNTERPART:
        assert not hasattr(tcore, name), name
        return
    theirs, ours = getattr(jcore, name), getattr(tcore, name)
    assert callable(ours) == callable(theirs), name
    assert isinstance(ours, type) == isinstance(theirs, type), name
    if isinstance(theirs, dict):            # rule tables: the same rules
        assert set(ours) == set(theirs), name
    elif isinstance(theirs, (tuple, float)):
        assert ours == theirs, name


def test_cut_masks_are_the_cut_rules_and_oracle_passes_the_references():
    assert tcore.edpp_cut_mask is tcore.CUT_RULES["edpp_cut"]
    assert tcore.gap_cut_mask is tcore.CUT_RULES["gap_cut"]
    for rule in (*jcore.RULES, "safe", "dome", "strong", "none"):
        assert tcore.oracle_x_passes(rule) == jcore.oracle_x_passes(rule)
        assert tcore.engine_x_passes(rule) == jcore.engine_x_passes(rule)
    assert tcore.FistaResult is tcore.GroupFistaResult is tcore.SolveResult


def _problem(group: bool = False):
    if group:
        X, y, _ = group_lasso_problem(40, 120, 5, active_groups=4, seed=1,
                                      dtype=np.float32)
        lam = 0.3 * float(np.max(np.linalg.norm(
            (X.T.astype(np.float64) @ y).reshape(-1, 5), axis=1))
            / np.sqrt(5))
    else:
        X, y, _ = lasso_problem(40, 120, nnz=6, seed=1, dtype=np.float32)
        lam = 0.3 * float(np.abs(X.T.astype(np.float64) @ y).max())
    return X, y, lam


@pytest.mark.parametrize("solver", ["fista", "cd", "group_fista"])
def test_one_shot_solvers_match_the_reference(solver):
    """The same numpy inputs through both packages at tol 1e-6, each with
    its own default Lipschitz constant (power iterations from different
    random starts): both converge, β within beta_err_tol(y, 1e-6)."""
    X, y, lam = _problem(group=solver == "group_fista")
    args = (X, y, lam) + ((5,) if solver == "group_fista" else ())
    ops.reset_counts()
    port = getattr(tcore, solver)(*args, tol=TOL, device="cpu")
    theirs = getattr(jcore, solver)(*(jnp.asarray(a) if isinstance(
        a, np.ndarray) else a for a in args), tol=TOL)
    assert bool(port.converged) and bool(theirs.converged)
    assert port.beta.dtype == torch.float32 and port.beta.shape == (120,)
    err = float(np.abs(port.beta.numpy() - np.asarray(theirs.beta)).max())
    print(f"{solver}: iterations port {port.iters}, reference "
          f"{int(theirs.iters)}; gap checks {port.gap_checks}; max|Δβ| "
          f"{err:.3g}")
    assert err <= beta_err_tol(y, TOL)
    if solver == "fista":             # the solver backend's step, per iter
        assert ops.plain_counts()["fista_step"] == port.iters


def test_one_shot_fista_with_the_references_lipschitz_takes_its_steps():
    """Given the reference's L, FISTA runs the same iterations (checked
    every 10) in both packages: the same host momentum sequence and
    float32 step."""
    X, y, lam = _problem()
    L = float(jcore.top_eigenpair(jnp.asarray(X))[0]) * 1.05
    port = tcore.fista(X, y, lam, tol=TOL, lipschitz=L, device="cpu")
    theirs = jcore.fista(jnp.asarray(X), jnp.asarray(y), lam, tol=TOL,
                         lipschitz=L)
    print(f"fista at the reference's L: {port.iters} and "
          f"{int(theirs.iters)} iterations")
    assert port.iters == int(theirs.iters)
    assert float(np.abs(port.beta.numpy() - np.asarray(theirs.beta)).max()) \
        <= 1e-5 * max(1.0, float(np.abs(np.asarray(theirs.beta)).max()))


def test_one_shot_solvers_follow_the_device_and_the_backend():
    X, y, lam = _problem()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcore.fista(X, y, lam)              # host arrays: the card
    res = tcore.fista(torch.from_numpy(X), torch.from_numpy(y), lam,
                      tol=TOL, backend="torch")
    assert res.beta.device.type == "cpu"
    b0 = np.zeros(120, np.float32)
    again = tcore.fista(X, y, lam, b0, tol=TOL, device="cpu")
    assert torch.equal(res.beta, again.beta) and res.iters == again.iters
    with pytest.raises(ValueError, match="unknown backend"):
        tcore.fista(X, y, lam, backend="nope", device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tcore.group_fista(X, y, lam, 7, device="cpu")
    assert tcore.default_solver_backend() == "cuda"
    assert tcore.default_solver_backend("cpu") == "torch"
    assert tcore.resolve_solver_backend(None, "cpu").name == "torch"
    assert tcore.resolve_solver_backend("cuda").name == "cuda"


def _warned(fn, name):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = fn()
    msgs = [str(w.message) for w in seen
            if issubclass(w.category, DeprecationWarning)]
    assert any(f"repro_torch.core.{name} is deprecated" in m
               for m in msgs), msgs
    return out


@pytest.mark.parametrize("shim", ["lasso_path", "lasso_path_batched",
                                  "group_lasso_path", "GroupPathConfig"])
def test_deprecated_shims_are_their_session_calls(shim):
    cfg = PathConfig(solve=SolveSpec(tol=TOL))
    if shim == "group_lasso_path" or shim == "GroupPathConfig":
        X, y, _ = group_lasso_problem(30, 100, 5, active_groups=3, seed=2,
                                      dtype=np.float32)
        grid = np.linspace(0.9, 0.2, 8) * float(np.max(np.linalg.norm(
            (X.T @ y).reshape(-1, 5), axis=1)) / np.sqrt(5))
    else:
        X, y, _ = lasso_problem(30, 100, nnz=5, seed=2, dtype=np.float32)
        grid = np.linspace(0.9, 0.2, 8) * float(np.abs(X.T @ y).max())
    if shim == "lasso_path":
        got = _warned(lambda: tcore.lasso_path(X, y, grid, cfg,
                                               device="cpu"), shim)
        want = LassoSession.fit(X, config=cfg, device="cpu").path(
            y, grid).squeeze()
    elif shim == "lasso_path_batched":
        Y = np.stack([y, 0.5 * y + 0.1])
        got = _warned(lambda: tcore.lasso_path_batched(
            X, Y, None, cfg, num_lambdas=6, lo_frac=0.3, device="cpu"), shim)
        want = LassoSession.fit(X, config=cfg, device="cpu").path(
            Y, None, num_lambdas=6, lo_frac=0.3)
        with pytest.raises(ValueError, match="shape"):
            _warned(lambda: tcore.lasso_path_batched(X, y, device="cpu"),
                    shim)
    elif shim == "group_lasso_path":
        got = _warned(lambda: tcore.group_lasso_path(X, y, 5, grid, cfg,
                                                     device="cpu"), shim)
        want = LassoSession.fit(X, groups=5, config=cfg, device="cpu").path(
            y, grid).squeeze()
    else:
        gcfg = _warned(lambda: tcore.GroupPathConfig(solver_tol=TOL), shim)
        assert gcfg.solve.strategy == "group_fista"
        assert gcfg.solve.bucket_min == 16 and gcfg.solve.tol == TOL
        got = LassoSession.fit(X, groups=5, config=gcfg, device="cpu").path(
            y, grid).squeeze()
        want = LassoSession.fit(X, groups=5, config=cfg, device="cpu").path(
            y, grid).squeeze()
    np.testing.assert_array_equal(got.lambdas, want.lambdas)
    np.testing.assert_array_equal(got.masks, want.masks)
    np.testing.assert_array_equal(got.betas, want.betas)
    assert [s.x_passes for s in got.stats] == [s.x_passes for s in
                                                 want.stats]


@pytest.mark.parametrize("cols", [(0, 300), (100, 164), (257, 300)])
def test_block_scores_are_the_fused_pass_bit_for_bit(cols):
    """On a column block: without norms, the fused pass's scores; with
    the norms that pass gave, the same bits again (the engine's
    arithmetic); and the block's bits are the whole width's there."""
    rng = np.random.default_rng(cols[0])
    X = torch.from_numpy(rng.standard_normal((50, 300)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal(50).astype(np.float32))
    lo, hi = cols
    blk = X[:, lo:hi].contiguous()
    scores, sumsq = ref.edpp_screen_ref(blk, c, 0.37)
    got = tcore.block_scores(blk, c, 0.37)
    assert torch.equal(got, scores)
    assert torch.equal(tcore.block_scores(blk, c, 0.37, torch.sqrt(sumsq)),
                       scores)
    assert torch.equal(got, tcore.block_scores(X, c, 0.37)[lo:hi])
    want = np.asarray(jcore.block_scores(jnp.asarray(blk.numpy()),
                                         jnp.asarray(c.numpy()), 0.37))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_backend_registry_runs_a_registered_backend_only_by_name():
    assert tcore.available_backends() == ("cuda", "torch")
    assert tcore.default_backend() == "cuda"
    assert tcore.default_backend("cpu") == "torch"
    assert tcore.resolve_backend(None, "cpu").name == "torch"
    mine = ops.BACKENDS["torch"]._replace(name="mine")
    with pytest.raises(ValueError, match="built in"):
        tcore.register_backend("cuda", mine)
    with pytest.raises(TypeError, match="ScreenBackend"):
        tcore.register_backend("mine", object())
    tcore.register_backend("mine", mine)
    try:
        assert tcore.available_backends() == ("cuda", "torch", "mine")
        assert tcore.default_backend() == "cuda"
        assert tcore.resolve_backend("mine") is mine
        X, y, _ = lasso_problem(30, 100, nnz=5, seed=2, dtype=np.float32)
        cfg = PathConfig(screen=ScreenSpec(backend="mine"),
                         solve=SolveSpec(backend="mine", tol=TOL))
        sess = LassoSession.fit(X, config=cfg, device="cpu")
        res = sess.path(y, **GRID)
        assert sess.backend_name == "mine"
        live = [s for s in res.stats if s.screen_backend]
        assert {(s.screen_backend, s.solver_backend) for s in live} == {
            ("mine", "mine")}
        plain = LassoSession.fit(X, device="cpu").path(
            y, **GRID, config=PathConfig(solve=SolveSpec(tol=TOL)))
        np.testing.assert_array_equal(res.masks, plain.masks)
        assert LassoSession.fit(X, device="cpu").backend_name == "torch"
    finally:
        ops.BACKENDS.pop("mine")


def test_group_dual_state_and_group_screen_match_the_reference():
    X, y, _ = group_lasso_problem(40, 120, 5, active_groups=4, seed=1,
                                  dtype=np.float32)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    lmax = float(tcore.group_lambda_max(Xt, yt, 5))
    beta = np.zeros(120, np.float32)
    beta[:5] = 0.1
    for lam in (lmax, 0.6 * lmax):
        st = tcore.make_group_dual_state(Xt, yt, torch.from_numpy(beta), lam,
                                         lmax, 5)
        sj = jcore.make_group_dual_state(Xj, yj, jnp.asarray(beta), lam,
                                         lmax, 5)
        for a, b in zip(st, sj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                       atol=2e-6)
        for rule in ("edpp", "strong"):
            mt = tcore.group_screen(Xt, yt, 0.5 * lmax, st, 5, rule=rule)
            mj = jcore.group_screen(Xj, yj, 0.5 * lmax, sj, 5, rule=rule)
            np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def _run_example(*args, timeout=240):
    """One example in a subprocess on one thread (beside the test
    workers, a threaded BLAS oversubscribes the cores)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_quickstart_twin_runs_quick():
    out = _run_example("examples/quickstart_torch.py", "--quick",
                       "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    line = next(s for s in out.stdout.splitlines()
                if s.startswith("max |beta_screened - beta_plain|"))
    # the example's problem and tol: two solutions at the relative gap
    # 1e-10 differ by at most beta_err_tol(y, 1e-10)
    y = lasso_problem(60, 400, nnz=12, corr=0.5, sigma=0.1)[1]
    assert float(line.split("=")[1].split()[0]) <= beta_err_tol(y, 1e-10)
    assert "backend torch" in out.stdout


def test_distributed_twin_runs_quick_on_two_gloo_ranks():
    out = _run_example("examples/distributed_screening_torch.py", "--quick",
                       "--device", "cpu", "--mesh", "1x2")
    assert out.returncode == 0, out.stderr[-2000:]
    for want in ("mesh: query 1 x feature 2 on cpu",
                 "screen backend shard:torch",
                 "session masks == unsharded session masks: True",
                 "distributed FISTA"):
        assert want in out.stdout, (want, out.stdout[-2000:])
