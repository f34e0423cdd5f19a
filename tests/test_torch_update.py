"""Dictionary updates (``session.update``) on the CPU, in the port
(``repro_torch``) against the reference (``repro``) and against a cold
fit of the port on the edited X.

The contract, per test:

* ``make_plan``: the reference's :class:`UpdatePlan` (every field and
  property) and its ``ValueError`` messages, for every edit case;
  ``carry_mask`` the reference's bits, single and batched masks;
* the oracle refit (port only): after ``update`` the geometry's X,
  ‖x_j‖², ‖x_j‖, bf16 copy and ``:err``, and a live workspace's |Xᵀy|,
  argmax and λ_max (one query and a batch) equal a cold ``fit`` of the
  edited X bit for bit; after ``reset_solver_cache()`` the path's masks
  and β equal the cold fit's bit for bit;
* against the reference's ``session.update`` on the same edits: the
  ``UpdateReport`` fields equal, the path's masks equal outside BAND of
  the EDPP threshold either path tested (counted), β within
  ``beta_err_tol(y, 1e-6)``; balanced, append-only, drop-only, mixed both
  ways and a dropped argmax, and three updates in turn;
* a caller's float32 numpy X is unchanged by an update (the fit aliases
  it on the CPU), and later updates patch the session's own buffers in
  place;
* ``geometry_version``, ``eig_cache_stats`` and the serve loop's
  ``DispatchRecord.version`` behave as the reference's;
* the plain sums an update carries do not depend on the width.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LassoSession as JSession
from repro.core import PathConfig as JConfig
from repro.core import PathWorkspace as JWorkspace
from repro.core import SolveSpec as JSolve
from repro.core import carry_mask as jcarry_mask
from repro.core import make_plan as jmake_plan
from repro.data.pipeline import lasso_problem
from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
from repro_torch.core.engine import PathWorkspace
from repro_torch.core.update import (UpdatePlan, carry_mask, make_plan,
                                     update_workspace)
from repro_torch.kernels import edpp_screen, ops, ref
from repro_torch.launch import serve_loop as sl
from test_torch_launch import _edpp_margins

N, P, B = 50, 400, 3
TOL = 1e-6
BAND = 1e-4
LMAX_RTOL = 1e-6    # λ_max: float32 dots summed in another order
GRID = dict(num_lambdas=6, hi_frac=0.95, lo_frac=0.2)


def beta_err_tol(y, solver_tol, kappa=25.0):
    """benchmarks/common.py: two gap-ε solutions differ by ≤ this."""
    y = np.asarray(y, np.float64)
    return kappa * float(np.sqrt(solver_tol * 0.5 * float(y @ y)))


@pytest.fixture(scope="module")
def problem():
    X, y, _ = lasso_problem(N, P, nnz=10, seed=21, dtype=np.float32)
    rng = np.random.default_rng(22)
    W = np.zeros((B, P))
    for w in W:
        w[rng.choice(P, 10, replace=False)] = rng.uniform(-1.0, 1.0, 10)
    Y = (W @ X.T.astype(np.float64)
         + 0.1 * rng.standard_normal((B, N))).astype(np.float32)
    adds = {k: rng.standard_normal((N, k)).astype(np.float32)
            for k in (3, 7)}
    istar = int(np.argmax(np.abs(X.T.astype(np.float64) @ y)))
    return dict(X=X, y=y, Y=Y, adds=adds, istar=istar)


def _edit(problem, case):
    """(drop, add) of an edit case."""
    p, adds, istar = P, problem["adds"], problem["istar"]
    return {
        "balanced": ([3, 17, 50], adds[3]),
        "append": (None, adds[3]),
        "drop": ([0, 9, p - 1], None),
        "mixed_add": ([5, 40], adds[7]),
        "mixed_drop": ([2, 11, 23, 31, 44, 59], adds[3]),
        "argmax": ([istar, (istar + 1) % p, (istar + 2) % p], adds[3]),
    }[case]


CASES = ["balanced", "append", "drop", "mixed_add", "mixed_drop", "argmax"]


def edited_oracle(Xh, drop, add):
    """The layout rule on the host: adds overwrite the first dropped slots
    in place, residual drops compact, residual adds append."""
    d = (np.unique(np.asarray(drop, dtype=np.int64)) if drop is not None
         else np.zeros(0, np.int64))
    a = (np.asarray(add, np.float32) if add is not None
         else np.zeros((Xh.shape[0], 0), np.float32))
    k = min(a.shape[1], d.size)
    Xp = Xh.copy()
    if k:
        Xp[:, d[:k]] = a[:, :k]
    keep = np.setdiff1d(np.arange(Xh.shape[1]), d[k:])
    return np.concatenate([Xp[:, keep], a[:, k:]], axis=1)


def _cfg():
    return PathConfig(solve=SolveSpec(tol=TOL))


def _fit(X):
    """A port session with its bf16 copy and error bound made."""
    sess = LassoSession.fit(X, device="cpu", config=_cfg())
    sess.geometry.screen_copy(torch.bfloat16)
    sess.geometry.screen_err(torch.bfloat16)
    return sess


def _jfit(X):
    sess = JSession.fit(X, config=JConfig(solve=JSolve(tol=TOL)))
    sess.geometry.screen_copy(jnp.bfloat16)
    sess.geometry.screen_err(jnp.bfloat16)
    return sess


def _equal(a, b, what):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and np.array_equal(a, b), what


def outside_band(X, Y, res_a, res_b, what: str) -> int:
    """Masks of two paths on one grid agree except on columns whose
    EDPP score lies within BAND of the threshold in the step either path
    tested (float64, from each path's own previous solution); β within
    ``beta_err_tol(y, TOL)``. Returns (and prints) the flips."""
    Y = np.asarray(Y).reshape(-1, X.shape[0])
    flips = 0
    for q, yq in enumerate(Y):
        np.testing.assert_array_equal(res_a.lambdas[q], res_b.lambdas[q])
        diff = res_a.masks[q] != res_b.masks[q]
        margins = [_edpp_margins(X, yq, res.lambdas[q], res.betas[q])
                   for res in (res_a, res_b)]
        for k in range(diff.shape[0]):
            da, db = margins[0][k], margins[1][k]
            if da is None or db is None:
                assert not diff[k].any(), (what, q, k)
                continue
            near = (np.abs(da) <= BAND) | (np.abs(db) <= BAND)
            assert not (diff[k] & ~near).any(), (what, q, k)
        flips += int(diff.sum())
        err = float(np.abs(res_a.betas[q] - res_b.betas[q]).max())
        assert err <= beta_err_tol(yq, TOL), (what, q, err)
    print(f"{what}: {flips} mask flips, all in the band")
    return flips


# ---------------------------------------------------------------------------
# the plan and the mask carry
# ---------------------------------------------------------------------------

def _plan_fields(plan, probe):
    return (plan.p_old, plan.n_add, plan.n_drop, plan.n_recycle,
            plan.n_append, plan.pure_recycle, plan.p_new,
            plan.keep_idx.tolist(), plan.drop_idx.tolist(),
            plan.recycle_idx.tolist(), plan.recycle_new_idx.tolist(),
            plan.touched_new_idx.tolist(), plan.new_index(probe).tolist(),
            plan.dropped(probe).tolist())


@pytest.mark.parametrize("case", CASES)
def test_make_plan_matches_reference(problem, case):
    drop, add = _edit(problem, case)
    plan, X_add = make_plan(P, add, drop)
    jplan, jX_add = jmake_plan(P, add, drop)
    assert isinstance(plan, UpdatePlan)
    probe = np.arange(P)
    assert _plan_fields(plan, probe) == _plan_fields(jplan, probe)
    if add is None:
        assert X_add is None and jX_add is None
    else:
        _equal(X_add, jX_add, "X_add")


@pytest.mark.parametrize("bad", [
    dict(), dict(drop=[10]), dict(drop=[-1]), dict(drop=[0.5]),
    dict(drop=[[0, 1]]), dict(drop=[0, 1, 2]), dict(add=np.zeros(4)),
])
def test_make_plan_refuses_as_the_reference(bad):
    p = 3 if bad.get("drop") == [0, 1, 2] else 10
    with pytest.raises(ValueError) as want:
        jmake_plan(p, **bad)
    with pytest.raises(ValueError) as got:
        make_plan(p, **bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", CASES)
def test_carry_mask_matches_reference(problem, case):
    drop, add = _edit(problem, case)
    plan, _ = make_plan(P, add, drop)
    jplan, _ = jmake_plan(P, add, drop)
    rng = np.random.default_rng(len(case))
    for shape in ((P,), (4, P), (2, 4, P)):
        m = rng.random(shape) < 0.6
        got = carry_mask(m, plan)
        _equal(got, jcarry_mask(m, jplan), f"carry_mask {shape}")
        assert got.shape == shape[:-1] + (plan.p_new,)


# ---------------------------------------------------------------------------
# the oracle refit: a cold fit of the edited X, bit for bit
# ---------------------------------------------------------------------------

def _workspaces(sess, y, Y):
    return (PathWorkspace(None, torch.from_numpy(y), geometry=sess.geometry),
            PathWorkspace(None, torch.from_numpy(Y), geometry=sess.geometry))


def _hold_to_cold(sess, wss, X_ed, y, Y, what):
    """The session after its updates against a cold fit of X_ed."""
    cold = _fit(X_ed)
    g, c = sess.geometry, cold.geometry
    _equal(sess.X, X_ed, f"{what}: X against the layout rule")
    for name in ("X", "sumsq", "col_norms"):
        _equal(getattr(g, name), getattr(c, name), f"{what}: {name}")
    _equal(g.screen_copy(torch.bfloat16).float(),
           c.screen_copy(torch.bfloat16).float(), f"{what}: bf16 copy")
    _equal(g.screen_err(torch.bfloat16), c.screen_err(torch.bfloat16),
           f"{what}: bf16 err")
    for ws, fresh in zip(wss, _workspaces(cold, y, Y)):
        _equal(ws.abs_xty, fresh.abs_xty, f"{what}: |Xᵀy|")
        _equal(ws.istar, fresh.istar, f"{what}: argmax")
        _equal(ws.lam_max, fresh.lam_max, f"{what}: λ_max")
        _equal(ws.v1_at_lmax, fresh.v1_at_lmax, f"{what}: v1")
    sess.reset_solver_cache()
    for Yq in (y, Y):
        ru, rc = sess.path(Yq, **GRID), cold.path(Yq, **GRID)
        _equal(ru.masks, rc.masks, f"{what}: masks")
        _equal(ru.betas, rc.betas, f"{what}: betas")
    return cold


@pytest.mark.parametrize("case", CASES)
def test_update_is_a_cold_fit_bit_for_bit(problem, case):
    X, y, Y = problem["X"], problem["y"], problem["Y"]
    drop, add = _edit(problem, case)
    sess = _fit(X)
    wss = _workspaces(sess, y, Y)
    sess.path(y, **GRID)                  # warm eigenvectors to carry
    rep = sess.update(add=add, drop=drop, workspaces=wss)
    X_ed = edited_oracle(X, drop, add)
    assert (rep.version, sess.version, rep.p) == (1, 1, X_ed.shape[1])
    assert sess.shape == X_ed.shape and sess.geometry.p == X_ed.shape[1]
    _hold_to_cold(sess, wss, X_ed, y, Y, case)
    if case == "argmax":
        assert rep.argmax_rescans >= 1


# ---------------------------------------------------------------------------
# against the reference's session.update
# ---------------------------------------------------------------------------

def _reports_equal(rep, jrep):
    fields = ("version", "p", "n_add", "n_drop", "geometries_updated",
              "eig_buckets_carried", "workspaces_updated", "argmax_rescans")
    assert [getattr(rep, f) for f in fields] \
        == [getattr(jrep, f) for f in fields]


@pytest.mark.parametrize("case", CASES)
def test_update_matches_the_reference_session(problem, case):
    X, y, Y = problem["X"], problem["y"], problem["Y"]
    drop, add = _edit(problem, case)
    sess, js = _fit(X), _jfit(X)
    wss = _workspaces(sess, y, Y)
    jws = [JWorkspace(None, jnp.asarray(y), geometry=js.geometry),
           JWorkspace(None, jnp.asarray(Y), geometry=js.geometry)]
    sess.path(y, **GRID)
    js.path(jnp.asarray(y), **GRID)
    rep = sess.update(add=add, drop=drop, workspaces=wss)
    jrep = js.update(add=add, drop=drop, workspaces=jws)
    _reports_equal(rep, jrep)
    assert sess.version == js.version == 1
    X_ed = edited_oracle(X, drop, add)
    for ws, jw in zip(wss, jws):
        _equal(ws.istar, jw.istar, "argmax against the reference")
        np.testing.assert_allclose(ws.lam_max, jw.lam_max, rtol=LMAX_RTOL)
    sess.reset_solver_cache()
    js.reset_solver_cache()
    res = sess.path(Y, **GRID)
    jres = js.path(jnp.asarray(Y), res.lambdas)     # on the port's grids
    outside_band(X_ed, Y, res, jres, f"{case} against the reference")


def test_three_updates_in_turn(problem):
    """Three balanced edits in turn (the second and third patch the
    session's own buffers): the cold fit's bits, the reference's reports,
    its masks outside the band."""
    X, y, Y = problem["X"], problem["y"], problem["Y"]
    rng = np.random.default_rng(11)
    sess, js = _fit(X), _jfit(X)
    wss = _workspaces(sess, y, Y)
    jws = [JWorkspace(None, jnp.asarray(y), geometry=js.geometry),
           JWorkspace(None, jnp.asarray(Y), geometry=js.geometry)]
    X_ed = X
    for step in range(3):
        drop = np.sort(rng.choice(X_ed.shape[1], size=5, replace=False))
        add = rng.standard_normal((N, 5)).astype(np.float32)
        rep = sess.update(add=add, drop=drop, workspaces=wss)
        jrep = js.update(add=add, drop=drop, workspaces=jws)
        _reports_equal(rep, jrep)
        X_ed = edited_oracle(X_ed, drop, add)
    assert sess.version == 3 and sess.geometry.version == 3
    _hold_to_cold(sess, wss, X_ed, y, Y, "three updates")
    js.reset_solver_cache()
    sess.reset_solver_cache()
    res = sess.path(y, **GRID)
    outside_band(X_ed, y, res, js.path(jnp.asarray(y), res.lambdas[0]),
                 "three updates")


# ---------------------------------------------------------------------------
# buffers, versions, caches, serving
# ---------------------------------------------------------------------------

def test_a_callers_x_is_never_written(problem):
    """On the CPU the fit shares a float32 numpy X with the caller: the
    first update copies before it patches, later ones patch the session's
    own buffers in place."""
    X = problem["X"].copy()
    X0 = X.copy()
    sess = LassoSession.fit(X, device="cpu")
    assert np.shares_memory(sess.X.numpy(), X)
    add = problem["adds"][3]
    sess.update(add=add, drop=[1, 2, 3])
    _equal(X, X0, "the caller's X after the first update")
    assert not np.shares_memory(sess.X.numpy(), X)
    own = sess.X
    sess.update(add=add, drop=[4, 5, 6])
    assert sess.X is own and sess.geometry.X is own
    _equal(X, X0, "the caller's X after the second update")
    _equal(sess.X, edited_oracle(edited_oracle(X0, [1, 2, 3], add),
                                 [4, 5, 6], add), "the edited X")


def test_path_stats_record_the_geometry_version(problem):
    X, y = problem["X"], problem["y"]
    sess = LassoSession.fit(X, device="cpu", config=_cfg())
    r0 = sess.path(y, num_lambdas=3)
    r0b = sess.path(problem["Y"], num_lambdas=3)
    assert all(s.geometry_version == 0 for s in r0.stats + r0b.stats)
    sess.update(add=problem["adds"][3], drop=[7, 8, 9])
    r1 = sess.path(y, num_lambdas=3)
    r1b = sess.path(problem["Y"], num_lambdas=3)
    assert all(s.geometry_version == 1 for s in r1.stats + r1b.stats)
    # a backend fitted after the edit joins at the current version
    other = sess._geometry("torch")
    assert other.version == sess.version == 1


def test_eig_cache_stays_warm_across_an_update(problem):
    """Warm Lipschitz starts keep hitting after an edit, as in the
    reference; ``reset_solver_cache`` makes the next path cold."""
    X, y = problem["X"], problem["y"]
    sess = LassoSession.fit(X, device="cpu", config=_cfg())
    sess.path(y, num_lambdas=4)
    s0 = sess.eig_cache_stats
    assert s0["cold"] > 0 and set(s0) == {"warm", "cold"}
    rep = sess.update(add=problem["adds"][3], drop=[3, 4, 5])
    assert rep.eig_buckets_carried == len(sess._eig_cache) > 0
    sess.path(y, num_lambdas=4)
    s1 = sess.eig_cache_stats
    assert s1["warm"] > s0["warm"]
    sess.reset_solver_cache()
    sess.path(y, num_lambdas=4)
    assert sess.eig_cache_stats["cold"] > s1["cold"]


def test_serve_loop_tickets_span_an_update(problem):
    """An update landing between dispatches: each DispatchRecord carries
    the version its batch ran against (tests/test_update.py:351)."""
    X, Y = problem["X"], problem["Y"]
    sess = LassoSession.fit(X, device="cpu", config=_cfg())
    ex = sl.SessionExecutor(sess, num_lambdas=4)
    arrivals = sl.ScriptedArrivals([(0.0, Y[0]), (5.0, Y[1])])
    versions = []

    def after(ticket):
        if not versions:            # the first retirement edits X
            sess.update(add=problem["adds"][3], drop=[0, 1, 2])
        versions.append(sess.version)

    loop = sl.ServeLoop(arrivals, ex,
                        policy=sl.ServePolicy(b_max=4, deadline_s=0.5,
                                              queue_cap=8),
                        clock=sl.VirtualClock(), on_complete=after)
    rep = loop.run()
    assert [r.version for r in rep.trace] == [0, 1]
    assert versions == [1, 1]
    assert all(t.error is None for t in rep.tickets)


def test_update_refuses_what_it_does_not_take(problem):
    X, y = problem["X"], problem["y"]
    sess = LassoSession.fit(X, device="cpu")
    ws = PathWorkspace(None, torch.from_numpy(y), geometry=sess.geometry)
    plan, X_add = make_plan(P, add=None, drop=[0, 1])   # p shrinks by 2
    with pytest.raises(ValueError, match="update the geometry first"):
        update_workspace(ws, plan, X_add)
    with pytest.raises(ValueError, match=f"n={N}"):
        sess.update(add=np.zeros((N + 1, 2), np.float32), drop=[0, 1])
    with pytest.raises(ValueError, match="add= and/or drop="):
        sess.update()
    assert sess.version == 0
    rng = np.random.default_rng(0)
    grp = LassoSession.fit(rng.standard_normal((16, 24)).astype(np.float32),
                           groups=4, device="cpu")
    with pytest.raises(NotImplementedError, match="plain-Lasso only"):
        grp.update(drop=[0])


def test_bf16_screen_and_solve_after_an_update(problem):
    """The carried bf16 copy and bound serve both mixed-precision options:
    the bf16 screen gives the float32 masks bit for bit after an edit,
    and the bf16 solve runs its bf16 phase on the carried copy."""
    X, y = problem["X"], problem["y"]
    sess = _fit(X)
    sess.update(add=problem["adds"][3], drop=[5, 6, 7])
    out = {}
    for dt in ("float32", "bfloat16"):
        sess.reset_solver_cache()
        out[dt] = sess.path(y, **GRID, config=PathConfig(
            screen=ScreenSpec(screen_dtype=dt), solve=SolveSpec(tol=TOL)))
    _equal(out["bfloat16"].masks, out["float32"].masks, "bf16 screen")
    sess.reset_solver_cache()
    r = sess.path(y, **GRID, config=PathConfig(
        solve=SolveSpec(tol=TOL, solve_dtype="bfloat16")))
    live = [s for s in r.stats if s.screen_backend]
    assert live and all(s.solve_dtype_effective == "bfloat16" for s in live)
    assert sum(s.solver_lo_iters for s in live) > 0
    outside_band(edited_oracle(X, [5, 6, 7], problem["adds"][3]), y, r,
                 out["float32"], "bf16 solve after an update")


# ---------------------------------------------------------------------------
# the sums an update carries do not depend on the width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(50, 400), (777, 1001)])
def test_block_sums_are_the_whole_widths_bits(shape):
    """The plain fused pass's ‖x_j‖² and dots and the bf16 error bound of
    a block of columns (``wide_p`` given, as an update passes it) are the
    whole width's bits at those columns; on the card the block's plan
    keeps the wide pass's tile and cluster."""
    n, p = shape
    rng = np.random.default_rng(p)
    X = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    cols = np.sort(rng.choice(p, 37, replace=False))
    blk = X[:, cols].contiguous()
    s_full, ss_full = edpp_screen.edpp_screen_scores(X, c, 0.3)
    s_blk, ss_blk = edpp_screen.edpp_screen_scores(blk, c, 0.3, wide_p=p)
    _equal(ss_blk, ss_full[cols], "sumsq")
    _equal(s_blk, s_full[cols], "scores")
    _equal(ref.column_sumsq(blk), ss_full[cols], "column_sumsq")
    _equal(edpp_screen.screen_matvec(blk, c, wide_p=p),
           edpp_screen.screen_matvec(X, c)[cols], "dots")
    Xb = X.to(torch.bfloat16)
    _equal(ops.bf16_column_err(blk, blk.to(torch.bfloat16)),
           ops.bf16_column_err(X, Xb)[cols], "bf16 err")
    for sms in (132, 114):
        for c_w in (8, 37, 2500):
            wide = edpp_screen.launch_plan(784, 50000, 1, sms, True)
            pl = edpp_screen.retest_plan(784, c_w, 50000, 1, sms, True)
            assert (pl.tile, pl.split) == (wide.tile, wide.split)
