"""Group sessions on a mesh, and meshes with more than one feature axis,
on the CPU over gloo: in-process at world size 1 (a 1×1 mesh), and in
worlds of 2 ranks (1×2) and 4 ranks (1×4), spawned once, at the same
time, through tests/torch_dist_worker.py (``job="group"``,
:func:`torch_dist_worker.compute_group`). The world of 4 also builds a
``("query", "a", "b")`` mesh of shape (1, 2, 2) over the same ranks.

The contract, per test:

* ``fit(X, groups=m, mesh=)``: the masks, n_discarded, x_passes, bucket,
  KKT rounds, λ grids and β of group EDPP, group strong and hybrid
  EDPP + strong (one query) and of a (2, n) batch, and the fitted
  spectral norms, equal the unsharded port group session's bit for bit
  at world sizes 1, 2 and 4 (the unsharded arms run on one thread, as
  every spawned rank does); ``backend_name`` is ``"shard:torch"``;
* against the reference's unsharded group session and its 1×1 mesh
  group session (on an Auto-axis ``Mesh``; see ``reference``): masks equal
  outside BAND of the threshold the reference's scores are held to,
  β within ``beta_err_tol(y, 1e-6)``, x_passes equal, and n_discarded,
  bucket and KKT rounds equal at every step where no mask flipped;
* groups that a rank's block cannot hold whole are refused with a
  ``ValueError`` naming p, m and F;
* the group pass on a block of whole groups with ``wide_p`` (and the
  plain version without it) gives the full width's scores bit for bit,
  and ``group_wide_plan`` takes the wide pass's tile and cluster;
* the (1, 2, 2) mesh gives the (1, 4) mesh's results bit for bit: the
  plain session's path for one query and a (4, n) batch, the group
  session's paths, and ``dist_fista`` ``"none"`` and ``"chunked"``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_worker as worker
from repro.core import LassoSession as JSession
from repro.core import PathConfig as JConfig
from repro.core import ScreenSpec as JScreen
from repro.core import SolveSpec as JSolve
from repro.data.pipeline import group_lasso_problem, lasso_problem
from repro_torch.kernels import group_screen, ops, ref
from test_torch_bf16_mesh import one_thread
from test_torch_session import BAND, _reference_group_scores, beta_err_tol

MESHES = {1: (1, 1), 2: (1, 2), 4: (1, 4)}
WORLDS = (1, 2, 4)
M = worker.GROUP_M
ARM_KEYS = [f"g_{r}{'_hybrid' if h else ''}" for r, h in worker.GROUP_ARMS]
FIELDS = ("lambdas", "betas", "masks", "stats")


@pytest.fixture(scope="module")
def problem():
    X, y, _ = lasso_problem(40, 256, nnz=8, seed=0, dtype=np.float32)
    Xs, ys, _ = lasso_problem(50, 400, nnz=10, seed=4, dtype=np.float32)
    rng = np.random.default_rng(5)
    W = np.zeros((4, Xs.shape[1]))
    for w in W:
        w[rng.choice(Xs.shape[1], 10, replace=False)] = rng.uniform(-1, 1, 10)
    Ys = (W @ Xs.T.astype(np.float64)
          + 0.1 * rng.standard_normal((4, Xs.shape[0]))).astype(np.float32)
    Xg, yg, _ = group_lasso_problem(40, 480, M, active_groups=6, seed=2,
                                    dtype=np.float32)
    yg2 = group_lasso_problem(40, 480, M, active_groups=6, seed=3,
                              dtype=np.float32)[1]
    X64 = X.astype(np.float64)
    return dict(
        X=X, y=y, lam_max=np.float32(np.abs(X64.T @ y).max()),
        lipschitz=np.float32(1.05 * np.linalg.norm(X64, 2) ** 2),
        Xs=Xs, ys=ys, Ys=Ys, Xg=Xg, yg=yg, Yg=np.stack([yg, yg2]))


@pytest.fixture(scope="module")
def worlds(problem, tmp_path_factory):
    """World size → :func:`torch_dist_worker.compute_group`'s results: 1
    in-process, 2 and 4 in spawned worlds run at the same time."""
    workdir = str(tmp_path_factory.mktemp("group"))
    np.savez(os.path.join(workdir, "inputs.npz"), **problem)
    started = [worker.start_world(w, MESHES[w], workdir, "group")
               for w in (2, 4)]
    with one_thread(), worker.one_rank() as mesh:
        results = {1: worker.compute_group(mesh, problem)}
    for w, s in zip((2, 4), started):
        results[w] = worker.join_world(s)
    return results


@pytest.fixture(scope="module")
def unsharded(problem):
    """The same group session arms without a mesh."""
    with one_thread():
        out = worker.group_paths(None, problem)
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in out.items()}


@pytest.fixture(scope="module")
def reference(problem):
    """The reference's group EDPP and group strong paths, from its
    unsharded session and its 1×1 mesh session, on the port's grid. The
    mesh is ``Mesh(devices, ("model",))``, whose axis is Auto: the
    installed jax's ``jax.make_mesh`` makes Explicit axes, under which
    the reference's group path raises ``ShardingTypeError`` at the
    λ̄_max ray (its matmul of two sharded operands)."""
    Xg, yg = problem["Xg"], problem["yg"]
    mesh = Mesh(np.array(jax.devices()[:1]), ("model",))
    out = {}
    for where, kw in (("plain", {}), ("mesh", {"mesh": mesh})):
        for rule in ("edpp", "strong"):
            cfg = JConfig(screen=JScreen(rule=rule),
                          solve=JSolve(tol=worker.PATH_TOL))
            js = JSession.fit(Xg, groups=M, config=cfg, **kw)
            out[where, rule] = (js, js.path(jnp.asarray(yg), **worker.GRID))
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_group_mesh_session_is_the_unsharded_session_bit_for_bit(
        worlds, unsharded, world):
    out = worlds[world]
    assert str(out["backend"]) == "shard:torch"
    assert str(unsharded["backend"]) == "torch"
    keys = [k for k in unsharded if k not in ("backend",)]
    assert len(keys) == 4 * (len(ARM_KEYS) + 1) + 4
    for k in keys:
        np.testing.assert_array_equal(out[k], unsharded[k], err_msg=k)
    assert int(out["fit_passes"]) == 1
    assert tuple(out["shape"]) == (40, 480)
    live = out["g_edpp_stats"][:, 1]
    assert (live[live > 0] == 1).all()              # one pass a screen


@pytest.mark.parametrize("rule", ["edpp", "strong"])
@pytest.mark.parametrize("where", ["plain", "mesh"])
@pytest.mark.parametrize("world", WORLDS)
def test_group_mesh_session_matches_the_reference(
        worlds, reference, problem, world, where, rule):
    js, res_j = reference[where, rule]
    assert js.backend_name == "jnp"
    out = worlds[world]
    lambdas, betas, masks, stats = (out[f"g_{rule}_{k}"] for k in FIELDS)
    Xg, yg = problem["Xg"], problem["yg"]
    np.testing.assert_allclose(lambdas, res_j.lambdas, rtol=2 ** -22,
                               atol=0)
    scores = _reference_group_scores(js, Xg, yg, res_j, rule)
    flips = 0
    for k, s_j in enumerate(res_j.stats):
        diff = masks[0, k] != res_j.masks[0, k]
        if k in scores:
            sc, th = scores[k]
            assert not (diff & ~(np.abs(sc - th) <= BAND)).any(), k
        else:
            assert not diff.any(), k
        flips += int(diff.sum())
        assert stats[k, 1] == s_j.x_passes, k
        if not diff.any():
            assert tuple(stats[k, [0, 2, 3]]) == (
                s_j.n_discarded, s_j.bucket, s_j.kkt_rounds), k
    err = float(np.abs(betas - res_j.betas).max())
    print(f"world {world} vs the reference's {where} session, group "
          f"{rule}: {flips} mask flips in the band; max|Δβ| {err:.3g}")
    assert err <= beta_err_tol(yg, worker.PATH_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_groups_a_block_cannot_hold_whole_are_refused(worlds, world):
    msg = str(worlds[world]["refused"])
    assert f"m={worker.REFUSED_M}" in msg and "p=480" in msg, msg
    assert f"F={world}" in msg, msg


@pytest.mark.parametrize("n, p, m, parts", [
    (40, 480, 5, 2), (40, 480, 5, 4), (33, 360, 12, 3), (20, 800, 200, 2)])
def test_wide_p_group_scores_are_the_full_widths_on_a_block(n, p, m, parts):
    rng = np.random.default_rng(n + p + m)
    X = torch.from_numpy(rng.standard_normal((n, p)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    full = group_screen.group_screen_scores(X, c, m)
    w = p // parts
    ops.reset_counts()
    for r in range(parts):
        block = X[:, r * w:(r + 1) * w].contiguous()
        for wide in (p, None):
            got = group_screen.group_screen_scores(block, c, m, wide_p=wide)
            assert torch.equal(got, full[r * w // m:(r + 1) * w // m]), r
    assert ops.plain_counts()["group_screen_scores"] == 2 * parts
    want = torch.linalg.vector_norm(
        (X.double().T @ c.double()).reshape(-1, m), dim=1)
    torch.testing.assert_close(full.double(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n, p, wide_p, m", [
    (250, 100000, 200000, 10), (250, 1200, 2400, 10), (777, 500, 1000, 5),
    (64, 400, 1600, 200)])
def test_group_wide_plan_takes_the_wide_passes_order(n, p, wide_p, m):
    sms = 132
    wide = group_screen.group_plan(n, wide_p, m, sms, True)
    own = group_screen.group_plan(n, p, m, sms, True)
    plan = group_screen.group_wide_plan(n, p, wide_p, m, sms, True)
    assert (plan.tile, plan.split, plan.stage_rows) == (
        wide.tile, wide.split, wide.stage_rows)
    assert plan.grid == (-(-p // plan.tile), plan.split)
    assert plan.vec == own.vec
    print(f"{n} x {p} of {wide_p}, m={m}: own split {own.split}, wide "
          f"split {wide.split}")
    with pytest.raises(ValueError, match="wide_p"):
        group_screen.group_wide_plan(n, p, p - m, m, sms, True)


def test_a_narrow_blocks_own_plan_splits_its_rows_differently():
    """Why the mesh's group pass needs ``wide_p``: a rank's quarter of
    250 × 16 800 (m = 10; 35 tiles of 120 columns on 132 SMs) splits its
    rows over a cluster, where the whole width's 140 tiles fill the card
    without one; the row split changes the order of the sums."""
    own = group_screen.group_plan(250, 4200, 10, 132, True)
    wide = group_screen.group_plan(250, 16800, 10, 132, True)
    assert own.tile == wide.tile == 120
    assert (own.split, wide.split) == (2, 1)


def test_group_screen_ref_sums_as_before_to_rounding():
    """The plain group pass now sums by a fixed tree; against the
    matrix-product form it replaced: rtol 1e-5 (float32 sums in another
    order)."""
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.standard_normal((70, 300)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal(70).astype(np.float32))
    got = ref.group_screen_ref(X, c, 6)
    want = torch.linalg.vector_norm((X.T @ c).reshape(-1, 6), dim=1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


SAME_KEYS = ("one", "batch")


@pytest.mark.parametrize("what", ["one", "batch", "fista", "group",
                                  "backend"])
def test_two_feature_axes_are_one_axis_bit_for_bit(worlds, what):
    out = worlds[4]
    if what in SAME_KEYS:
        keys = [f"{what}_{k}" for k in FIELDS]
        pairs = [(f"flat_{k}", f"axes_{k}") for k in keys]
    elif what == "fista":
        pairs = [(f"flat_fista_{m}", f"axes_fista_{m}")
                 for m in ("none", "chunked")]
    elif what == "group":
        keys = ["spec_norms", *(f"{a}_{k}" for a in (*ARM_KEYS, "g_batch")
                                for k in FIELDS)]
        pairs = [(k, f"axes_{k}") for k in keys]
    else:
        for key in ("flat_plain_backend", "axes_plain_backend", "backend",
                    "axes_backend"):
            assert str(out[key]) == "shard:torch", key
        assert tuple(out["axes_plain_shape"]) == (50, 400)
        pairs = [("flat_plain_shape", "axes_plain_shape"),
                 ("shape", "axes_shape")]
    for a, b in pairs:
        assert out[a].size, a
        np.testing.assert_array_equal(out[a], out[b], err_msg=a)
    if what == "fista":             # the iterates moved
        assert np.abs(out["flat_fista_none"]).max() > 0


@pytest.mark.parametrize("parts", [2, 4, 96])
def test_a_blocks_spectral_norms_are_the_whole_batchs(parts):
    """‖X_g‖₂ of a block's groups, one batched ``eigvalsh`` each (of one
    group at 96 blocks, solved beside a copy of itself), bit for bit the
    whole batch's at those groups."""
    from repro_torch.core.group_screening import group_spectral_norms
    rng = np.random.default_rng(parts)
    X = torch.from_numpy(rng.standard_normal((40, 480)).astype(np.float32))
    full = group_spectral_norms(X, M)
    w = 480 // parts
    got = torch.cat([group_spectral_norms(X[:, r * w:(r + 1) * w]
                                          .contiguous(), M)
                     for r in range(parts)])
    assert torch.equal(got, full)
