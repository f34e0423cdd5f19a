"""The port's distributed layer on the CPU against the reference's.

The same numpy problems (``repro.data.pipeline.lasso_problem``) go
through the reference's ``repro.core.distributed`` on a 1×1 JAX mesh and
through ``repro_torch.core.distributed`` over gloo: in-process at world
size 1 (a 1×1 mesh), and in spawned worlds of 2 ranks (a 1×2 mesh) and
4 ranks (a 2×2 mesh: two query rows of two feature shards). Each world
is spawned once; it runs every op, writes its global results to an
``.npz`` (tests/torch_dist_worker.py), and the tests compare them here.

Tolerances, stated per test:

* λ_max, ‖Xᵀr‖_∞ and scores: rtol 2e-5 (the reference's kernel-sweep
  tolerance: float32 dots summed in another order);
* masks: equal except for columns whose float64 score lies within
  BAND of the threshold 1 − eps (counted and printed);
* FISTA iterates: 1e-5·max(1, max|β|), float32 rounding carried through
  the iterations; between world sizes of the port the same;
* the mesh session (EDPP, and GAP, DOME and edpp_cut): at world size 1
  bit for bit the unsharded port's session; at 2 and 4 (and against the
  reference) the contract of tests/test_torch_session.py: masks outside
  the band, β within ``beta_err_tol(y, 1e-6)``, the pass counts equal.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import torch_dist_worker as worker
from repro.core import LassoSession as JSession
from repro.core import PathConfig as JConfig
from repro.core import ScreenSpec as JScreen
from repro.core import SolveSpec as JSolve
from repro.core import distributed as JD
from repro.data.pipeline import lasso_problem
from repro.kernels import ref as jref
from repro.kernels.prox_step import prox_step as jprox_step
from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
from repro_torch.core import distributed as PD
from repro_torch.core.engine import DictionaryGeometry
from repro_torch.kernels import ops, ref

EPS = 1e-6
BAND = 1e-4
RTOL = 2e-5
MESHES = {1: (1, 1), 2: (1, 2), 4: (2, 2)}


def beta_err_tol(y, solver_tol, kappa=25.0):
    """benchmarks/common.py: two gap-ε solutions differ by ≤ this."""
    y = np.asarray(y, np.float64)
    return kappa * float(np.sqrt(solver_tol * 0.5 * float(y @ y)))


def _lam_max_and_v1(X, y):
    corr = X.T @ y
    i = int(np.argmax(np.abs(corr)))
    return np.float32(abs(corr[i])), (np.sign(corr[i]) * X[:, i]).astype(
        np.float32)


@pytest.fixture(scope="module")
def problem():
    """Global numpy inputs, shared by every world and the reference."""
    X, y, beta = lasso_problem(40, 256, nnz=8, seed=0, dtype=np.float32)
    Ys = [y] + [lasso_problem(40, 256, nnz=8, seed=s, dtype=np.float32)[1]
                for s in (1, 2, 3)]
    Y = np.stack(Ys).astype(np.float32)
    lam_max, v1 = _lam_max_and_v1(X, y)
    pairs = [_lam_max_and_v1(X, yb) for yb in Ys]
    lam_max_b = np.array([lm for lm, _ in pairs], np.float32)
    beta = beta.astype(np.float32)
    # queries 0, 1 from β = 0 at λ_max; queries 2, 3 from β* at 0.6·λ_max
    beta_b = np.stack([np.zeros_like(beta)] * 2 + [beta] * 2)
    Xs, ys, _ = lasso_problem(50, 400, nnz=10, seed=4, dtype=np.float32)
    # a (4, n) batch against the session's dictionary: 10-sparse truths
    rng = np.random.default_rng(5)
    W = np.zeros((4, Xs.shape[1]))
    for w in W:
        w[rng.choice(Xs.shape[1], 10, replace=False)] = rng.uniform(-1, 1, 10)
    Ys = (W @ Xs.T.astype(np.float64)
          + 0.1 * rng.standard_normal((4, Xs.shape[0]))).astype(np.float32)
    return dict(
        X=X, y=y, Y=Y, beta=beta, r=(y - X @ beta).astype(np.float32),
        lam_max=lam_max, v1=v1, lam_prev=np.float32(0.6 * lam_max),
        lam_next=np.float32(0.5 * lam_max),
        col_norms=np.sqrt((X.astype(np.float64) ** 2).sum(0)).astype(
            np.float32),
        active=np.flatnonzero(beta), lam_max_b=lam_max_b,
        v1_b=np.stack([v for _, v in pairs]),
        lam_prev_b=(lam_max_b * np.array([1, 1, 0.6, 0.6])).astype(
            np.float32),
        lam_next_b=(lam_max_b * np.array([0.5, 0.8, 0.5, 0.4])).astype(
            np.float32),
        beta_b=beta_b, lam_b=(0.3 * lam_max_b).astype(np.float32),
        lipschitz=np.float32(1.05 * np.linalg.norm(X.astype(np.float64),
                                                   2) ** 2),
        Xs=Xs, ys=ys, Ys=Ys)


@pytest.fixture(scope="module")
def reference(problem):
    """The reference's distributed functions on a 1×1 JAX mesh (screens
    through the plain jnp kernels, FISTA through its Pallas kernels in
    interpret mode), and its 1×1 mesh session."""
    P = problem
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("query", "feature"))
    Xd, yd = JD.shard_problem(mesh, P["X"], P["y"])
    lmd, _, _, sup_d = JD.make_dist_ops(mesh, "jnp")
    out = {"lambda_max": lmd(Xd, yd), "sup_corr": sup_d(Xd, P["r"])}
    lam_max, v1 = float(P["lam_max"]), jnp.asarray(P["v1"])
    act = P["active"]
    for tag, beta, lam_prev in (("zero", np.zeros_like(P["beta"]), lam_max),
                                ("warm", P["beta"], float(P["lam_prev"]))):
        args = (float(P["lam_next"]), lam_prev, jnp.asarray(beta), lam_max,
                v1)
        out[f"edpp_mask_{tag}"], out[f"edpp_{tag}"] = JD.dist_edpp_screen(
            mesh, Xd, yd, *args, backend="jnp")
        out[f"cached_{tag}"], out[f"cached_mask_{tag}"] = \
            JD.dist_edpp_screen_cached(mesh, Xd, yd, *args, P["col_norms"],
                                       backend="jnp")
        out[f"sparse_{tag}"], out[f"sparse_mask_{tag}"] = \
            JD.dist_edpp_screen_sparse(
                mesh, Xd, jnp.asarray(P["X"][:, act]), yd, args[0], lam_prev,
                jnp.asarray(beta[act]), lam_max, v1, P["col_norms"],
                backend="jnp")
    out["batched_mask"], out["batched"] = JD.dist_edpp_screen_batched(
        mesh, Xd, jnp.asarray(P["Y"]), P["lam_next_b"], P["lam_prev_b"],
        jnp.asarray(P["beta_b"]), jnp.asarray(P["lam_max_b"]),
        jnp.asarray(P["v1_b"]), P["col_norms"], backend="jnp")
    out["power"] = JD.dist_power_iteration(mesh, Xd, backend="jnp")
    zero = jnp.zeros((P["X"].shape[1],), jnp.float32)
    for mode in ("none", "chunked", "stale"):
        iters = worker.STALE_ITERS if mode == "stale" else worker.FISTA_ITERS
        out[f"fista_{mode}"] = JD.dist_fista(
            mesh, Xd, yd, 0.3 * lam_max, zero, float(P["lipschitz"]),
            iters=iters, overlap=mode, solver_backend="interpret")
    out["fista_batched"] = JD.dist_fista_batched(
        mesh, Xd, jnp.asarray(P["Y"]), jnp.asarray(P["lam_b"]),
        jnp.zeros(P["Y"].shape[:1] + P["X"].shape[1:], jnp.float32),
        float(P["lipschitz"]), iters=worker.FISTA_ITERS,
        solver_backend="interpret")
    js = JSession.fit(P["Xs"], mesh=mesh,
                      config=JConfig(solve=JSolve(tol=worker.PATH_TOL)))
    res = js.path(P["ys"], **worker.GRID)
    out.update(path_lambdas=res.lambdas, path_betas=res.betas,
               path_masks=res.masks, path_stats=_stats(res),
               path_fit_passes=np.array(js.fit_passes),
               path_backend=np.array(js.backend_name))
    for rule in worker.MESH_RULES:
        js.reset_solver_cache()
        res = js.path(P["ys"], **worker.GRID, config=JConfig(
            screen=JScreen(rule=rule), solve=JSolve(tol=worker.PATH_TOL)))
        out.update({f"{rule}_lambdas": res.lambdas,
                    f"{rule}_betas": res.betas, f"{rule}_masks": res.masks,
                    f"{rule}_stats": _stats(res)})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def unsharded(problem):
    """The port's unsharded session on the path problem."""
    sess = LassoSession.fit(problem["Xs"], device="cpu", config=PathConfig(
        solve=SolveSpec(tol=worker.PATH_TOL)))
    return sess.path(problem["ys"], **worker.GRID)


@pytest.fixture(scope="module")
def unsharded_rules(problem):
    """The port's unsharded session on the path problem, per rule of
    ``worker.MESH_RULES``."""
    sess = LassoSession.fit(problem["Xs"], device="cpu")
    out = {}
    for rule in worker.MESH_RULES:
        sess.reset_solver_cache()
        out[rule] = sess.path(problem["ys"], **worker.GRID,
                              config=worker.rule_config(rule))
    return out


@pytest.fixture(scope="module")
def unsharded_batch(problem):
    """The port's unsharded session on the (4, n) path batch."""
    sess = LassoSession.fit(problem["Xs"], device="cpu", config=PathConfig(
        solve=SolveSpec(tol=worker.PATH_TOL)))
    return sess.path(problem["Ys"], **worker.GRID)


@pytest.fixture(scope="module")
def worlds(problem, tmp_path_factory):
    """World size → the port's global results: 1 in-process, 2 and 4 in
    spawned worlds (each joined with worker.JOIN_TIMEOUT_S)."""
    workdir = str(tmp_path_factory.mktemp("worlds"))
    np.savez(os.path.join(workdir, "inputs.npz"), **problem)
    with worker.one_rank() as mesh:
        results = {1: worker.compute(mesh, problem)}
    for world in (2, 4):
        results[world] = worker.spawn_world(world, MESHES[world], workdir)
    return results


def _close(port, ref_, rtol=RTOL):
    port, ref_ = np.asarray(port, np.float64), np.asarray(ref_, np.float64)
    assert port.shape == ref_.shape
    np.testing.assert_allclose(port, ref_, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(ref_).max()))


def _masks_outside_band(mask, mask_ref, scores_ref, what) -> int:
    """Masks agree except where the reference's score is within BAND of
    1 − eps; returns (and prints) the band count."""
    band = np.abs(np.asarray(scores_ref, np.float64) - (1.0 - EPS)) < BAND
    assert not np.any((mask != mask_ref) & ~band), what
    print(f"{what}: {int(band.sum())} columns in the band")
    return int(band.sum())


@pytest.mark.parametrize("world", [1, 2, 4])
def test_lambda_max_and_sup_corr_match_reference(worlds, reference, world):
    out = worlds[world]
    for key in ("lambda_max", "sup_corr"):
        _close(out[key], reference[key])


@pytest.mark.parametrize("screen", ["edpp", "cached", "sparse"])
@pytest.mark.parametrize("tag", ["zero", "warm"])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_edpp_screens_match_reference(worlds, reference, world, screen, tag):
    """Scores within rtol 2e-5; masks equal outside the band."""
    out, key = worlds[world], f"{screen}_{tag}"
    _close(out[key], reference[key])
    _masks_outside_band(out[f"{screen}_mask_{tag}"],
                        reference[f"{screen}_mask_{tag}"], reference[key],
                        f"{key} world {world}")
    assert out[f"{screen}_mask_{tag}"].any()      # the screen discards


@pytest.mark.parametrize("world", [1, 2, 4])
def test_batched_screen_matches_reference_and_single_screens(
        worlds, reference, world):
    """Scores (B, p) within rtol 2e-5 of the reference's, masks outside
    the band; query 0 (β = 0 at λ_max) is the single-query zero screen."""
    out = worlds[world]
    _close(out["batched"], reference["batched"])
    _masks_outside_band(out["batched_mask"], reference["batched_mask"],
                        reference["batched"], f"batched world {world}")
    _close(out["batched"][0], out["cached_zero"])


@pytest.mark.parametrize("world", [1, 2, 4])
def test_power_iteration_bounds_the_spectral_norm(worlds, reference,
                                                  problem, world):
    """A Rayleigh quotient: at most ‖X‖₂² (float32 rounding, rtol 1e-5)
    and, after 30 iterations, at least ‖X‖₂²/1.05, so 1.05× it bounds the
    FISTA step. Both packages (different random starts) meet it; the
    port's world sizes start alike and agree to rtol 2e-5."""
    norm2 = np.linalg.norm(problem["X"].astype(np.float64), 2) ** 2
    for est in (float(worlds[world]["power"]), float(reference["power"])):
        assert norm2 / 1.05 <= est <= norm2 * (1 + 1e-5), (est, norm2)
    _close(worlds[world]["power"], worlds[1]["power"])


@pytest.mark.parametrize("mode", ["none", "chunked", "stale"])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_dist_fista_matches_reference(worlds, reference, world, mode):
    """Same L, λ and start: the iterates after 100 iterations ("stale": 5)
    within 1e-5·max(1, max|β|); "none" runs the fista_step op once per
    iteration, "chunked" and "stale" the prox_step op."""
    out = worlds[world]
    b, b_ref = out[f"fista_{mode}"], reference[f"fista_{mode}"]
    assert np.abs(b - b_ref).max() <= 1e-5 * max(1.0, np.abs(b_ref).max())
    iters = worker.STALE_ITERS if mode == "stale" else worker.FISTA_ITERS
    want = [iters, 0] if mode == "none" else [0, iters]
    assert out[f"launches_{mode}"].tolist() == want
    if mode == "chunked":           # the same iterates as "none"
        assert np.abs(b - out["fista_none"]).max() \
            <= 1e-5 * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("world", [1, 2, 4])
def test_dist_fista_batched_matches_reference_and_single_runs(
        worlds, reference, world):
    """B = 4 queries: within 1e-5·max(1, max|β|) of the reference's batch;
    query 0 (y, λ = 0.3·λ_max) is the single-query "none" run."""
    out = worlds[world]
    b, b_ref = out["fista_batched"], reference["fista_batched"]
    tol = 1e-5 * max(1.0, np.abs(b_ref).max())
    assert b.shape == b_ref.shape and np.abs(b - b_ref).max() <= tol
    assert np.abs(b[0] - out["fista_none"]).max() <= tol


def _path_scores(X, y, lambdas, betas):
    """Per step, the float64 EDPP scores the path's screen tested, built
    from the path's own previous solution (None at λ ≥ λ_max)."""
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    norms = np.linalg.norm(X64, axis=0)
    corr = X64.T @ y64
    i = int(np.argmax(np.abs(corr)))
    lmax = abs(corr[i])
    theta, v1 = y64 / lmax, np.sign(corr[i]) * X64[:, i]
    out = []
    for lam, beta in zip(lambdas, betas):
        if lam >= lmax:
            out.append(None)
            continue
        v2 = y64 / lam - theta
        vp = v2 - (v1 @ v2) / (v1 @ v1) * v1
        out.append(np.abs(X64.T @ (theta + 0.5 * vp))
                   + 0.5 * np.linalg.norm(vp) * norms)
        theta = (y64 - X64 @ beta) / lam
        v1 = y64 / lam - theta
    return out


def _stats(res):
    return np.array([(s.n_discarded, s.x_passes, s.bucket)
                     for s in res.stats])


def _same_path(port, ref_, X, y, what):
    """The session contract between two paths, each (lambdas, betas,
    masks, stats (n_discarded, x_passes, bucket) per step): masks equal
    outside the band of the scores the reference path tested, β within
    beta_err_tol, n_discarded off by at most the step's band flips,
    x_passes equal, buckets equal where nothing flipped."""
    _, betas, masks, stats = port
    lambdas_r, betas_r, masks_r, stats_r = ref_
    flips = masks[0] != masks_r[0]
    for k, scores in enumerate(_path_scores(X, y, lambdas_r[0], betas_r[0])):
        band = np.zeros_like(flips[k]) if scores is None \
            else np.abs(scores - (1.0 - EPS)) < BAND
        assert not (flips[k] & ~band).any(), (what, k)
    assert np.abs(betas - betas_r).max() <= beta_err_tol(y, 1e-6)
    n_flip = flips.sum(axis=1)
    assert (np.abs(stats[:, 0] - stats_r[:, 0]) <= n_flip).all(), what
    assert (stats[:, 1] == stats_r[:, 1]).all(), what
    assert (stats[n_flip == 0, 2] == stats_r[n_flip == 0, 2]).all(), what
    print(f"{what}: {int(flips.sum())} mask flips, all in the band")


@pytest.mark.parametrize("world", [1, 2, 4])
def test_mesh_session_matches_unsharded_and_reference(
        worlds, reference, unsharded, problem, world):
    out = worlds[world]
    assert out["path_backend"] == "shard:torch"
    assert reference["path_backend"] == "shard:jnp"
    assert out["path_fit_passes"] == reference["path_fit_passes"] == 1
    assert tuple(out["path_shape"]) == problem["Xs"].shape
    port = tuple(out[f"path_{k}"] for k in ("lambdas", "betas", "masks",
                                            "stats"))
    plain = (unsharded.lambdas, unsharded.betas, unsharded.masks,
             _stats(unsharded))
    if world == 1:                 # bit for bit the unsharded session
        for a, b in zip(port, plain):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port[0], plain[0])
    np.testing.assert_allclose(port[0], reference["path_lambdas"],
                               rtol=2 ** -22)
    X, y = problem["Xs"], problem["ys"]
    _same_path(port, plain, X, y, f"world {world} vs unsharded")
    _same_path(port, tuple(reference[f"path_{k}"] for k in (
        "lambdas", "betas", "masks", "stats")), X, y,
        f"world {world} vs reference")


@pytest.mark.parametrize("world", [1, 2, 4])
def test_mesh_session_batch_matches_unsharded(worlds, unsharded_batch,
                                              problem, world):
    """A (4, n) batch on a mesh session: every rank returns the whole
    batch (the 2×2 mesh's query axis splits nothing), at world size 1 bit
    for bit the unsharded session's; at every size each query's masks
    equal outside the band of the scores its unsharded path tested, β
    within ``beta_err_tol(y_b, 1e-6)``, x_passes equal, and n_discarded
    and bucket equal at the steps where no mask flipped."""
    out, plain = worlds[world], unsharded_batch
    port = tuple(out[f"batch_{k}"] for k in ("lambdas", "betas", "masks",
                                              "stats", "converged"))
    want = (plain.lambdas, plain.betas, plain.masks, _stats(plain),
            plain.query_converged)
    assert port[1].shape == (4, worker.GRID["num_lambdas"], 400)
    if world == 1:
        for a, b in zip(port, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port[0], want[0])
    np.testing.assert_array_equal(port[4], want[4])
    X, Y = problem["Xs"], problem["Ys"]
    flips = port[2] != want[2]
    for b in range(4):
        for k, scores in enumerate(_path_scores(X, Y[b], want[0][b],
                                                want[1][b])):
            band = np.zeros_like(flips[b, k]) if scores is None \
                else np.abs(scores - (1.0 - EPS)) < BAND
            assert not (flips[b, k] & ~band).any(), (world, b, k)
        assert np.abs(port[1][b] - want[1][b]).max() \
            <= beta_err_tol(Y[b], worker.PATH_TOL)
    still = ~flips.any(axis=(0, 2))
    assert (port[3][:, 1] == want[3][:, 1]).all()
    assert (port[3][still][:, [0, 2]] == want[3][still][:, [0, 2]]).all()
    print(f"world {world}: {int(flips.sum())} batch mask flips, all in the "
          f"band")


@pytest.mark.parametrize("rule", worker.MESH_RULES)
@pytest.mark.parametrize("world", [1, 2, 4])
def test_mesh_rules_match_unsharded_and_reference(
        worlds, reference, unsharded_rules, problem, world, rule):
    """GAP, DOME and edpp_cut on mesh sessions (one all-gather per
    screen, two for DOME; the cut normal from the gathered λ_max column):
    at world size 1 bit for bit the unsharded session; at every size,
    against the unsharded session and the reference's 1×1 mesh session,
    masks equal outside the band of the scores the rule tested (counted),
    β within ``beta_err_tol(y, 1e-6)``, x_passes equal, n_discarded off by
    at most the step's flips and buckets equal where nothing flipped."""
    from test_torch_rules import path_bands
    out = worlds[world]
    keys = ("lambdas", "betas", "masks", "stats")
    port = tuple(out[f"{rule}_{k}"] for k in keys)
    res = unsharded_rules[rule]
    plain = (res.lambdas, res.betas, res.masks, _stats(res))
    if world == 1:
        for a, b in zip(port, plain):
            np.testing.assert_array_equal(a, b)
    X, y = problem["Xs"], problem["ys"]
    live = port[3][:, 1][port[3][:, 1] > 0]
    assert (live == (2 if rule == "dome" else 1)).all()
    for what, want in (("unsharded", plain), ("reference", tuple(
            reference[f"{rule}_{k}"] for k in keys))):
        flips = port[2][0] != want[2][0]
        bands = path_bands(X, y, want[0][0], want[1][0], rule)
        for k, band in enumerate(bands):
            outside = flips[k] if band is None else flips[k] & ~band
            assert not outside.any(), (what, k)
        assert np.abs(port[1] - want[1]).max() <= beta_err_tol(y, 1e-6)
        n_flip = flips.sum(axis=1)
        stats, stats_w = port[3], want[3]
        assert (np.abs(stats[:, 0] - stats_w[:, 0]) <= n_flip).all(), what
        assert (stats[:, 1] == stats_w[:, 1]).all(), what
        assert (stats[n_flip == 0, 2] == stats_w[n_flip == 0, 2]).all()
        print(f"{rule} world {world} vs {what}: {int(flips.sum())} mask "
              f"flips, all in the band")


@pytest.mark.parametrize("world", [2, 4])
def test_a_width_the_mesh_cannot_split_is_refused(worlds, world):
    msg = str(worlds[world]["indivisible"])
    assert "p=399" in msg and "feature size 2" in msg, msg


def test_mesh_sessions_refuse_what_this_slice_does_not_serve(problem):
    X, y = problem["Xs"], problem["ys"]
    with pytest.raises(RuntimeError, match="process group"):
        LassoSession.fit(X, mesh=object(), device="cpu")
    with worker.one_rank() as mesh:
        # a group session runs on a mesh now (tests/test_torch_group_mesh.py):
        # its fit gathers the unsharded spectral norms bit for bit
        gs = LassoSession.fit(X, groups=2, mesh=mesh, device="cpu")
        assert gs.backend_name == "shard:torch" and gs.shape == X.shape
        np.testing.assert_array_equal(
            gs.geometry.spec_norms,
            LassoSession.fit(X, groups=2, device="cpu").geometry.spec_norms)
        geom = DictionaryGeometry(torch.from_numpy(X))
        with pytest.raises(ValueError, match="cannot be combined"):
            LassoSession.fit(X, mesh=mesh, geometry=geom, device="cpu")
        cfg = PathConfig(solve=SolveSpec(tol=worker.PATH_TOL))
        sess = LassoSession.fit(X, mesh=mesh, device="cpu", config=cfg)
        Y = np.stack([y, 0.5 * y])
        res = sess.path(Y, **worker.GRID)     # a batch is served: parity
        plain = LassoSession.fit(X, device="cpu", config=cfg).path(
            Y, **worker.GRID)
        assert res.betas.shape == (2, worker.GRID["num_lambdas"], 400)
        np.testing.assert_array_equal(res.masks, plain.masks)
        np.testing.assert_array_equal(res.betas, plain.betas)
        # updates and bf16 run on a mesh session now
        # (tests/test_torch_bf16_mesh.py); an edit without columns or
        # with the wrong rows is still refused, and changes nothing
        with pytest.raises(ValueError, match="add= and/or drop="):
            sess.update()
        with pytest.raises(ValueError, match=f"n={X.shape[0]} rows"):
            sess.update(add=np.zeros((X.shape[0] + 1, 2), np.float32))
        assert sess.version == 0 and sess.shape == X.shape
    assert not dist.is_initialized()


def test_a_size_one_axis_runs_its_collectives(problem, monkeypatch):
    """At world size 1 the feature axis keeps its group: the mesh session
    issues real all-gathers and the dist ops real all-reduces (exact on
    one rank), so a 1-rank world drives the collective path the wider
    meshes take, and still matches the unsharded session bit for bit."""
    calls = {"all_reduce": 0, "all_gather": 0}
    for name in calls:
        real = getattr(dist, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(dist, name, counted)
    X, y = problem["Xs"], problem["ys"]
    cfg = PathConfig(screen=ScreenSpec(paranoid=True),
                     solve=SolveSpec(tol=worker.PATH_TOL))
    with worker.one_rank() as mesh:
        res = LassoSession.fit(X, mesh=mesh, config=cfg, device="cpu").path(
            y, **worker.GRID)
        assert calls["all_reduce"] == 0 and calls["all_gather"] > 0, calls
        Xl, yl = PD.shard_problem(mesh, X, y)
        lam_max = float(PD.make_dist_ops(mesh)[0](Xl, yl))
        assert calls["all_reduce"] == 1
    plain = LassoSession.fit(X, config=cfg, device="cpu").path(
        y, **worker.GRID)
    assert lam_max == float(ref.screen_matvec_ref(
        torch.from_numpy(X), torch.from_numpy(y)).abs().max())
    np.testing.assert_array_equal(res.masks, plain.masks)
    np.testing.assert_array_equal(res.betas, plain.betas)


def test_fit_adopts_a_prefitted_geometry(problem):
    X = torch.from_numpy(problem["Xs"])
    geom = DictionaryGeometry(X)
    sess = LassoSession.fit(None, geometry=geom)
    assert sess.geometry is geom and sess.X is X
    assert sess.fit_passes == 1 and sess.backend_name == "torch"


PROX_CASES = [((300,), "scalar"), ((257,), "scalar"), ((3, 300), "scalar"),
              ((3, 300), "per_query"), ((5, 1003), "per_query")]


@pytest.mark.parametrize("shape, params", PROX_CASES)
def test_prox_step_plain_matches_reference(shape, params):
    """Against the reference's Pallas prox_step (interpret mode) and its
    prox_step_ref: rtol = atol = 1e-6 (one rounding of step·λ apart: the
    reference's rank-1 path multiplies host floats in double). Zero
    columns (z = g = β_old = 0) stay exactly 0."""
    rng = np.random.default_rng(sum(shape))
    z, g, b = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    for a in (z, g, b):
        a[..., -7:] = 0.0
    if params == "scalar":
        step, lam, mom = 0.01, 0.5, 0.6
    else:
        step, lam, mom = (rng.uniform(0.005, 0.5, shape[0]).astype(
            np.float32) for _ in range(3))

    def t(a):
        return torch.from_numpy(np.asarray(a))

    ops.reset_counts()
    bn, zn = ref.prox_step_ref(t(z), t(g), t(b), *(
        t(s) if params != "scalar" else s for s in (step, lam, mom)))
    assert ops.plain_counts()["prox_step"] == 1
    assert bn.shape == zn.shape == shape and bn.dtype == torch.float32
    jargs = [jnp.asarray(a) for a in (z, g, b)] + [
        jnp.asarray(s) if params != "scalar" else s
        for s in (step, lam, mom)]
    for want in (jprox_step(*jargs, interpret=True),
                 jref.prox_step_ref(*jargs)):
        for port, r in zip((bn, zn), want):
            np.testing.assert_allclose(port.numpy(), np.asarray(r),
                                       rtol=1e-6, atol=1e-6)
    assert not bn[..., -7:].any() and not zn[..., -7:].any()


@pytest.mark.parametrize("shape", [(300,), (3, 257)])
@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_prox_step_plain_sums_parts_as_the_reference(shape, parts):
    """g as a (k, …) stack of the chunked gradient's parts: the plain
    version equals the chained sum g = part₀; g = g + partᵢ followed by
    the prox, bit for bit, with the parameters as host numbers or as a
    (3, B) block; and it matches the reference's Pallas prox_step
    (interpret mode) on ``functools.reduce(jnp.add, parts)`` within the
    tolerance of test_prox_step_plain_matches_reference (1e-6)."""
    rng = np.random.default_rng(10 * parts + len(shape))
    z, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    stack = rng.standard_normal((parts, *shape)).astype(np.float32)
    B = shape[0] if len(shape) == 2 else 1
    step, lam, mom = (rng.uniform(0.005, 0.5, B).astype(np.float32)
                      for _ in range(3))
    scalars = (step, lam, mom) if B > 1 else (float(step[0]), float(lam[0]),
                                              float(mom[0]))
    block = torch.from_numpy(np.stack([step, lam, mom]))

    def t(a):
        return torch.from_numpy(np.asarray(a))

    chained = t(stack[0])
    for part in stack[1:]:
        chained = chained + t(part)
    want = ref.prox_step_ref(t(z), chained, t(b), *(
        t(s) if B > 1 else s for s in scalars))
    ops.reset_counts()
    for got in (ref.prox_step_ref(t(z), t(stack), t(b), *(
                    t(s) if B > 1 else s for s in scalars)),
                ref.prox_step_ref(t(z), t(stack), t(b), params=block)):
        for a, w in zip(got, want):
            assert a.shape == shape and torch.equal(a, w)
    assert ops.plain_counts()["prox_step"] == 2
    g = functools.reduce(jnp.add, [jnp.asarray(a) for a in stack])
    jargs = [jnp.asarray(z), g, jnp.asarray(b)] + [
        jnp.asarray(s) if B > 1 else s for s in scalars]
    for port, r in zip(want, jprox_step(*jargs, interpret=True)):
        np.testing.assert_allclose(port.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)


def test_prox_step_plain_float64_keeps_its_dtype():
    z = torch.randn(2, 50, dtype=torch.float64)
    bn, zn = ref.prox_step_ref(z, z, z, 0.1, torch.tensor(
        [0.2, 0.3], dtype=torch.float64), 0.5)
    assert bn.dtype == zn.dtype == torch.float64
    want = torch.sign(0.9 * z) * torch.clamp(
        0.9 * z.abs() - 0.1 * torch.tensor([[0.2], [0.3]],
                                           dtype=torch.float64), min=0)
    torch.testing.assert_close(bn, want, rtol=1e-12, atol=1e-12)
