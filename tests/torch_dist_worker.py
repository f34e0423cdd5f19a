"""One rank of a gloo world for tests/test_torch_distributed.py.

``spawn_world(world, mesh_shape, workdir)`` starts ``world`` processes,
each of which joins a gloo process group through a FileStore under
``workdir``, builds a CPU DeviceMesh ``("query", "feature")`` of
``mesh_shape``, runs :func:`compute` on the problem in
``workdir/inputs.npz`` and, on rank 0, writes the global results to
``workdir/out_<world>.npz``. The processes are joined with a timeout, so
a rendezvous that hangs fails its test instead of stalling the suite.
``spawn_world(..., job="mixed")`` runs :func:`compute_mixed` instead
(tests/test_torch_bf16_mesh.py): bf16 screens and solves and dictionary
updates on a mesh session; ``job="group"`` runs :func:`compute_group`
(tests/test_torch_group_mesh.py): group sessions on a mesh and, in a
world of 4, a mesh with two feature axes against one with one.

:func:`compute` is also what the tests run in-process at world size 1,
inside :func:`one_rank`, and :func:`compute_mixed` also runs there and
with no mesh at all (the unsharded arms). Neither imports JAX: the
reference runs in the test process only.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
from repro_torch.core import distributed as D
from repro_torch.core.engine import BF16_FAST_RULES, PathWorkspace
from repro_torch.kernels import ops

JOIN_TIMEOUT_S = 120
FISTA_ITERS = 100
STALE_ITERS = 5          # "stale" diverges by design: a few steps only
PATH_TOL = 1e-6
GRID = dict(num_lambdas=20, hi_frac=0.95)
MESH_RULES = ("gap", "dome", "edpp_cut")


def rule_config(rule: str) -> PathConfig:
    """The mesh session's config for one of MESH_RULES."""
    return PathConfig(screen=ScreenSpec(rule=rule),
                      solve=SolveSpec(tol=PATH_TOL))


def compute(mesh, inp) -> dict[str, np.ndarray]:
    """Every distributed op of the port on ``inp`` (global numpy arrays),
    gathered back to global arrays: λ_max, ‖Xᵀr‖_∞, the four EDPP screens,
    the power iteration, FISTA in the three overlap modes and batched,
    and a mesh session's path for one query (EDPP and each of
    MESH_RULES) and for a (B, n) batch; with
    the launch and plain-version counts of the solver runs."""
    X, y, Y = inp["X"], inp["y"], inp["Y"]
    B = Y.shape[0]
    Xl = D.place_dictionary(mesh, X)
    yt = D.place_queries(mesh, y)
    lmd, _, _, sup_d = D.make_dist_ops(mesh)
    out = {"lambda_max": lmd(Xl, yt),
           "sup_corr": sup_d(Xl, D.place_queries(mesh, inp["r"]))}

    def feat(a):
        return D.place_features(mesh, a)

    def rows(a):
        return D.place_queries(mesh, a, batched=True)

    def whole(a, batched=False):
        mask = a.dtype == torch.bool        # gloo gathers no bool tensors
        a = D.gather_features(mesh, a.to(torch.uint8) if mask else a)
        a = D.gather_queries(mesh, a, B) if batched else a
        return a.bool() if mask else a

    lam_max, v1max = float(inp["lam_max"]), D.place_queries(mesh, inp["v1"])
    col_norms = feat(inp["col_norms"])
    for tag, beta, lam_prev in (("zero", np.zeros_like(inp["beta"]), lam_max),
                                ("warm", inp["beta"], float(inp["lam_prev"]))):
        lam_next = float(inp["lam_next"])
        args = (lam_next, lam_prev, feat(beta), lam_max, v1max)
        mask, scores = D.dist_edpp_screen(mesh, Xl, yt, *args)
        out[f"edpp_{tag}"] = whole(scores)
        out[f"edpp_mask_{tag}"] = whole(mask)
        scores, mask = D.dist_edpp_screen_cached(mesh, Xl, yt, *args,
                                                 col_norms)
        out[f"cached_{tag}"] = whole(scores)
        out[f"cached_mask_{tag}"] = whole(mask)
        act = inp["active"]
        scores, mask = D.dist_edpp_screen_sparse(
            mesh, Xl, D.place_dictionary(mesh, X[:, act]), yt, lam_next,
            lam_prev, feat(beta[act]), lam_max, v1max, col_norms)
        out[f"sparse_{tag}"] = whole(scores)
        out[f"sparse_mask_{tag}"] = whole(mask)

    Yq = rows(Y)
    mask, scores = D.dist_edpp_screen_batched(
        mesh, Xl, Yq, rows(inp["lam_next_b"]), rows(inp["lam_prev_b"]),
        rows(feat(inp["beta_b"])), rows(inp["lam_max_b"]), rows(inp["v1_b"]),
        col_norms)
    out["batched"] = whole(scores, True)
    out["batched_mask"] = whole(mask, True)

    out["power"] = D.dist_power_iteration(mesh, Xl)
    L, lam = float(inp["lipschitz"]), 0.3 * lam_max
    zero = feat(np.zeros(X.shape[1], np.float32))
    for mode in ("none", "chunked", "stale"):
        iters = STALE_ITERS if mode == "stale" else FISTA_ITERS
        ops.reset_counts()
        out[f"fista_{mode}"] = whole(D.dist_fista(
            mesh, Xl, yt, lam, zero, L, iters=iters, overlap=mode))
        out[f"launches_{mode}"] = np.array(
            [ops.plain_counts()[k] for k in ("fista_step", "prox_step")])
    out["fista_batched"] = whole(D.dist_fista_batched(
        mesh, Xl, Yq, rows(inp["lam_b"]), rows(feat(np.zeros(
            (B, X.shape[1]), np.float32))), L, iters=FISTA_ITERS), True)

    Xs, ys = inp["Xs"], inp["ys"]
    sess = LassoSession.fit(Xs, mesh=mesh, device="cpu",
                            config=PathConfig(solve=SolveSpec(tol=PATH_TOL)))
    res = sess.path(ys, **GRID)
    out.update(
        path_lambdas=res.lambdas, path_betas=res.betas, path_masks=res.masks,
        path_stats=np.array([(s.n_discarded, s.x_passes, s.bucket)
                             for s in res.stats]),
        path_fit_passes=np.array(sess.fit_passes),
        path_backend=np.array(sess.backend_name),
        path_shape=np.array(sess.shape))
    sess.reset_solver_cache()              # start cold, as a fresh session
    res = sess.path(inp["Ys"], **GRID)     # the whole batch on every rank
    out.update(
        batch_lambdas=res.lambdas, batch_betas=res.betas,
        batch_masks=res.masks, batch_converged=res.query_converged,
        batch_stats=np.array([(s.n_discarded, s.x_passes, s.bucket)
                              for s in res.stats]))
    for rule in MESH_RULES:              # the other screening rules
        sess.reset_solver_cache()
        res = sess.path(ys, **GRID, config=rule_config(rule))
        out.update({f"{rule}_lambdas": res.lambdas, f"{rule}_betas": res.betas,
                    f"{rule}_masks": res.masks,
                    f"{rule}_stats": np.array([(s.n_discarded, s.x_passes,
                                                s.bucket)
                                               for s in res.stats])})
    try:                                 # a width the mesh cannot split
        LassoSession.fit(Xs[:, :-1], mesh=mesh, device="cpu")
        out["indivisible"] = np.array("")
    except ValueError as e:
        out["indivisible"] = np.array(str(e))
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in out.items()}


MIXED_GRID = dict(num_lambdas=3, hi_frac=0.95, lo_frac=0.3)
SOLVE_ARMS = (("fista", "one"), ("cd", "one"), ("fista", "batch"))


def mixed_config(rule: str = "edpp", screen: str = "float32",
                 solve: str = "float32", strategy: str = "fista"
                 ) -> PathConfig:
    """The config of one arm of :func:`compute_mixed`."""
    return PathConfig(screen=ScreenSpec(rule=rule, screen_dtype=screen),
                      solve=SolveSpec(strategy=strategy, tol=PATH_TOL,
                                      solve_dtype=solve))


def edits(inp) -> list[tuple]:
    """The dictionary edits of :func:`compute_mixed`, in order: balanced
    (4 dropped, 4 added, the first of them the argmax of query 0), a
    compacting drop of 4, an append of 4, and a mixed edit that drops 4
    and adds 8. Each keeps p divisible by 4."""
    add = inp["add"]
    return [(inp["drop_bal"], add[:, :4]), (inp["drop_only"], None),
            (None, add[:, 4:8]), (inp["drop_mixed"], add[:, 8:16])]


def compute_mixed(mesh, inp, screens: bool = True
                  ) -> dict[str, np.ndarray]:
    """A session on the path problem (``Xs``, ``ys``, ``Ys``), on
    ``mesh`` or, with ``mesh=None``, unsharded: (1) unless ``screens`` is
    False, every rule of BF16_FAST_RULES screened in float32 and in bf16,
    one query and the (B, n) batch; (2) the bf16 solve, ``fista`` and ``cd`` on one query
    and ``fista`` on the batch; (3) the :func:`edits` in turn on a session
    with a fitted bf16 copy and a live batch workspace, each followed by
    the geometry's arrays (gathered), the workspace's fit and a path after
    ``reset_solver_cache()``; (4) the mesh's refusal of an edit to a
    width it cannot split. Every grid is ``MIXED_GRID``."""
    Xs, ys, Ys = inp["Xs"], inp["ys"], inp["Ys"]
    kw = {"device": "cpu"} if mesh is None else {"device": "cpu",
                                                 "mesh": mesh}
    out = {}

    def whole(a):
        return a if mesh is None else D.gather_features(mesh, a)

    sess = LassoSession.fit(Xs, **kw)
    for rule in BF16_FAST_RULES if screens else ():
        for tag, Y in (("one", ys), ("batch", Ys)):
            for dt in ("float32", "bfloat16"):
                sess.reset_solver_cache()
                res = sess.path(Y, **MIXED_GRID,
                                config=mixed_config(rule, screen=dt))
                out[f"screen_{rule}_{tag}_{dt}"] = res.masks
            out[f"screen_{rule}_{tag}_stats"] = np.array(
                [(s.screen_dtype_effective == "bfloat16", s.fallback_cols)
                 for s in res.stats if s.screen_backend])
    for strategy, tag in SOLVE_ARMS:
        sess.reset_solver_cache()
        res = sess.path(ys if tag == "one" else Ys, **MIXED_GRID,
                        config=mixed_config(solve="bfloat16",
                                            strategy=strategy))
        key = f"solve_{strategy}_{tag}"
        out.update({f"{key}_masks": res.masks, f"{key}_betas": res.betas,
                    f"{key}_lambdas": res.lambdas,
                    f"{key}_stats": np.array(
                        [(s.solve_dtype_effective == "bfloat16",
                          s.solver_lo_iters, s.bucket) for s in res.stats
                         if s.screen_backend])})

    sess = LassoSession.fit(Xs, **kw)
    err = sess.geometry.screen_err(torch.bfloat16)
    out["err"] = err
    ws = PathWorkspace(None, torch.from_numpy(Ys), geometry=sess.geometry)
    for i, (drop, add) in enumerate(edits(inp)):
        rep = sess.update(add=add, drop=drop, workspaces=[ws])
        geom = sess.geometry
        out.update({
            f"upd{i}_report": np.array([rep.version, rep.p,
                                        rep.argmax_rescans]),
            f"upd{i}_X": whole(geom.X),
            f"upd{i}_bf16": whole(geom.screen_copy(torch.bfloat16)).float(),
            f"upd{i}_sumsq": geom.sumsq, f"upd{i}_norms": geom.col_norms,
            f"upd{i}_err": geom.screen_err(torch.bfloat16),
            f"upd{i}_abs_xty": ws.abs_xty, f"upd{i}_istar": ws.istar,
            f"upd{i}_lam_max": ws.lam_max})
        sess.reset_solver_cache()
        res = sess.path(ys, **MIXED_GRID, config=mixed_config())
        out.update({f"upd{i}_masks": res.masks, f"upd{i}_betas": res.betas,
                    f"upd{i}_version": np.array(
                        [s.geometry_version for s in res.stats])})
    try:                              # an edit to a width F cannot split
        sess.update(drop=[0])
        out["update_indivisible"] = np.array("")
    except ValueError as e:
        out["update_indivisible"] = np.array(str(e))
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in out.items()}


GROUP_M = 5
GROUP_ARMS = (("edpp", False), ("strong", False), ("edpp", True))
REFUSED_M = 32        # divides the group problem's p = 480, not p/2 or p/4


def group_config(rule: str = "edpp", hybrid: bool = False) -> PathConfig:
    """A group session's config: ``rule`` (with the group strong rule
    ORed in when ``hybrid``) at PATH_TOL."""
    return PathConfig(screen=ScreenSpec(rule=rule, strong=hybrid),
                      solve=SolveSpec(tol=PATH_TOL))


def _path_out(res, key: str) -> dict:
    return {f"{key}_lambdas": res.lambdas, f"{key}_betas": res.betas,
            f"{key}_masks": res.masks, f"{key}_stats": np.array(
                [(s.n_discarded, s.x_passes, s.bucket, s.kkt_rounds)
                 for s in res.stats])}


def group_paths(mesh, inp) -> dict[str, np.ndarray]:
    """Group sessions (``groups=GROUP_M``) on the group problem (``Xg``,
    ``yg``, ``Yg``), on ``mesh`` or, with ``mesh=None``, unsharded: each
    of GROUP_ARMS from a cold solver cache, the (2, n) batch, the fit's
    spectral norms and the session's backend, passes and shape; on a
    mesh also the refusal of groups the blocks cannot hold whole."""
    kw = {"device": "cpu"} if mesh is None else {"device": "cpu",
                                                 "mesh": mesh}
    Xg, yg = inp["Xg"], inp["yg"]
    sess = LassoSession.fit(Xg, groups=GROUP_M, **kw)
    out = {"spec_norms": sess.geometry.spec_norms,
           "backend": np.array(sess.backend_name),
           "fit_passes": np.array(sess.fit_passes),
           "shape": np.array(sess.shape)}
    for rule, hybrid in GROUP_ARMS:
        sess.reset_solver_cache()
        res = sess.path(yg, **GRID, config=group_config(rule, hybrid))
        out.update(_path_out(res, f"g_{rule}{'_hybrid' if hybrid else ''}"))
    sess.reset_solver_cache()
    out.update(_path_out(sess.path(inp["Yg"], **GRID,
                                   config=group_config()), "g_batch"))
    out["query_passes"] = np.array(sess.query_passes)
    if mesh is not None:
        try:
            LassoSession.fit(Xg, groups=REFUSED_M, **kw)
            out["refused"] = np.array("")
        except ValueError as e:
            out["refused"] = np.array(str(e))
    return out


def axes_arms(mesh, inp) -> dict[str, np.ndarray]:
    """What a mesh's feature axes carry, for one mesh against another: a
    plain session's path for one query (``Xs``, ``ys``) and the (4, n)
    batch (``Ys``), and ``dist_fista`` ``"none"`` and ``"chunked"`` on
    ``X``, ``y`` (gathered to global arrays)."""
    out = {}
    sess = LassoSession.fit(inp["Xs"], mesh=mesh, device="cpu",
                            config=PathConfig(solve=SolveSpec(tol=PATH_TOL)))
    out.update(_path_out(sess.path(inp["ys"], **GRID), "one"))
    sess.reset_solver_cache()
    out.update(_path_out(sess.path(inp["Ys"], **GRID), "batch"))
    out["plain_backend"] = np.array(sess.backend_name)
    out["plain_shape"] = np.array(sess.shape)
    Xl, yt = D.place_dictionary(mesh, inp["X"]), D.place_queries(mesh,
                                                                 inp["y"])
    zero = D.place_features(mesh, np.zeros(inp["X"].shape[1], np.float32))
    lam = 0.3 * float(inp["lam_max"])
    for mode in ("none", "chunked"):
        out[f"fista_{mode}"] = D.gather_features(mesh, D.dist_fista(
            mesh, Xl, yt, lam, zero, float(inp["lipschitz"]),
            iters=FISTA_ITERS, overlap=mode))
    return out


def compute_group(mesh, inp) -> dict[str, np.ndarray]:
    """:func:`group_paths` on ``mesh``; in a world of 4 also
    :func:`axes_arms` on ``mesh`` (``"flat_"``) and, on a ``("query",
    "a", "b")`` mesh of shape (1, 2, 2) over the same ranks, both
    functions again (``"axes_"``)."""
    out = group_paths(mesh, inp)
    if dist.get_world_size() == 4:
        two = init_device_mesh("cpu", (1, 2, 2),
                               mesh_dim_names=("query", "a", "b"))
        for tag, m in (("flat", mesh), ("axes", two)):
            out.update({f"{tag}_{k}": v
                        for k, v in axes_arms(m, inp).items()})
        out.update({f"axes_{k}": v
                    for k, v in group_paths(two, inp).items()})
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in out.items()}


JOBS = {"compute": compute, "mixed": compute_mixed, "group": compute_group}


@contextlib.contextmanager
def one_rank():
    """A 1-rank gloo process group in this process and its (1, 1) CPU mesh
    ``("query", "feature")``; the group is torn down on exit, so none
    outlives its test."""
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
        try:
            yield init_device_mesh("cpu", (1, 1),
                                   mesh_dim_names=("query", "feature"))
        finally:
            dist.destroy_process_group()


def _run(rank: int, world: int, mesh_shape, workdir: str,
         job: str = "compute") -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, f"store_{world}"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", tuple(mesh_shape),
                                mesh_dim_names=("query", "feature"))
        with np.load(os.path.join(workdir, "inputs.npz")) as f:
            inp = dict(f)
        out = JOBS[job](mesh, inp)
        if rank == 0:
            np.savez(os.path.join(workdir, f"{job}_{world}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn_world(world: int, mesh_shape, workdir: str,
                job: str = "compute") -> dict:
    """Run ``JOBS[job]`` (:func:`compute` by default) in a spawned world;
    its global results."""
    return join_world(start_world(world, mesh_shape, workdir, job))


def start_world(world: int, mesh_shape, workdir: str,
                job: str = "compute"):
    """Spawn the world of :func:`spawn_world` without waiting for it (to
    run two worlds at once); :func:`join_world` collects it."""
    ctx = mp.start_processes(_run, args=(world, mesh_shape, workdir, job),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, world, workdir, job


def join_world(started) -> dict:
    """Join a :func:`start_world` world (killing it after
    ``JOIN_TIMEOUT_S``) and load its global results."""
    ctx, world, workdir, job = started
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"world of {world} ranks did not finish in "
                               f"{JOIN_TIMEOUT_S} s")
    with np.load(os.path.join(workdir, f"{job}_{world}.npz")) as f:
        return dict(f)
