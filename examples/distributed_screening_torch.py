"""Distributed EDPP screening + FISTA on the PyTorch port, over
``torch.distributed``.

Two levels, as ``examples/distributed_screening.py`` shows them:

  1. **The session front door**: ``LassoSession.fit(X, mesh=mesh)`` on a
     ``--mesh QxF`` DeviceMesh (axes ``("query", "feature")``) keeps each
     rank's column block of X, screens it with the same kernels as the
     unsharded engines and gathers the scores
     (``session.backend_name == "shard:<tile>"``); every rank solves the
     reduced buckets gathered replicated, so each returns the whole
     path, and the masks equal the unsharded session's.
  2. **The explicit suite** (:mod:`repro_torch.core.distributed`): the
     collectives the session path is built from, on each rank's block:
     λ_max with one scalar MAX, the EDPP screen with one n-vector SUM
     for the residual and no collective for the scores, and FISTA with
     one n-vector SUM per iteration (``"chunked"``: the sums split and
     overlapped with the gradient's parts).

    PYTHONPATH=src python examples/distributed_screening_torch.py \\
        [--quick] [--mesh QxF] [--device cpu]

One process per rank. On the CPU (``--device cpu``) the example starts
Q·F gloo ranks itself (a FileStore in a temporary directory); on the
card a ``1x1`` mesh runs on a one-rank NCCL group, and wider meshes need
one process per card under ``torchrun --nproc-per-node=Q·F``, which the
example joins when ``WORLD_SIZE`` is set. ``--quick`` shrinks the shapes
for smoke runs.
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import LassoSession, PathConfig, SolveSpec
from repro_torch.core import DualState, distributed as D, edpp_mask
from repro_torch.data import lasso_problem


def _args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small shapes for smoke runs")
    ap.add_argument("--mesh", default="1x1", metavar="QxF",
                    help="Q query shards × F feature shards (default 1x1)")
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (default: the card)")
    return ap.parse_args(argv)


def run(mesh, args, device: torch.device) -> dict:
    """Both levels on ``mesh``, as every rank calls them; prints on rank
    0 and returns the session's masks and the FISTA β gathered."""
    rank0 = dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    q, f = D.query_size(mesh), D.feature_size(mesh)
    say(f"mesh: query {q} x feature {f} on {device.type}")

    n, p = (64, 1 << 10) if args.quick else (256, 1 << 15)
    fista_iters = 60 if args.quick else 300
    X, y, beta_true = lasso_problem(n, p, nnz=40, sigma=0.1,
                                    dtype=np.float32)

    # ---- level 1: the session front door (per-block tile kernels) ------
    # float32 certifies a relative gap near 1e-6, not the default 1e-8
    cfg = PathConfig(solve=SolveSpec(tol=2e-5, max_iter=600))
    sess = LassoSession.fit(X, mesh=mesh, config=cfg, device=device)
    say(f"X: {n}x{p} split by columns -> {p // f} features a rank; "
        f"screen backend {sess.backend_name} (fit passes "
        f"{sess.fit_passes})")
    t0 = time.perf_counter()
    res = sess.path(y, num_lambdas=5, lo_frac=0.3)
    t_path = time.perf_counter() - t0
    for s in res.stats:
        say(f"  session path λ={s.lam:7.2f}: discarded {s.n_discarded:6d}"
            f"/{p} kept {s.n_kept:5d} iters {s.solver_iters}")
    say(f"session 5-point path on the mesh: {t_path:.2f}s (per-block "
        f"screens, replicated reduced solves)")
    plain = LassoSession.fit(X, config=cfg, device=device).path(
        y, num_lambdas=5, lo_frac=0.3)
    same = np.array_equal(res.masks, plain.masks)
    say(f"session masks == unsharded session masks: {same}")
    Yb = np.stack([y] * (2 * q)).astype(np.float32)
    res_b = sess.path(Yb, num_lambdas=3, lo_frac=0.3)
    say(f"batched path B={Yb.shape[0]} (whole on every rank): masks "
        f"{res_b.masks.shape}")

    # ---- level 2: the explicit suite on each rank's block -------------
    Xb, yb = D.shard_problem(mesh, X, y, device)
    lmax_d, _, _, _ = D.make_dist_ops(mesh)
    lm = float(lmax_d(Xb, yb))
    say(f"λ_max = {lm:.3f}  (one scalar MAX)")
    corr = X.T @ y
    istar = int(np.argmax(np.abs(corr)))
    v1max = D.place_queries(mesh, np.sign(corr[istar]) * X[:, istar], device)
    beta0 = D.place_features(mesh, np.zeros(p, np.float32), device)

    # basic (λ_max-state) screening is tight near λ_max; the sequential
    # rule carries the path (see quickstart_torch.py)
    lam = 0.8 * lm
    t0 = time.perf_counter()
    mask, _ = D.dist_edpp_screen(mesh, Xb, yb, lam, lm, beta0, lm, v1max)
    mask = D.gather_features(mesh, mask.to(torch.uint8)).bool()
    t_screen = time.perf_counter() - t0
    say(f"EDPP at λ={lam:.2f}: discarded {int(mask.sum())}/{p} features "
        f"in {t_screen * 1e3:.1f} ms (the scores need no collective)")
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    want = edpp_mask(Xt, yt, lam, DualState.at_lambda_max(Xt, yt))
    agree = float((mask.cpu() == want).float().mean())
    say(f"distributed mask == single-process mask on {agree:.4%} of the "
        f"columns")

    lam = 0.3 * lm                          # deeper into the path
    L = 1.05 * float(D.dist_power_iteration(mesh, Xb))
    t0 = time.perf_counter()
    beta = D.dist_fista(mesh, Xb, yb, lam, beta0, L, iters=fista_iters,
                        overlap="chunked")
    beta = D.gather_features(mesh, beta)
    say(f"distributed FISTA ({fista_iters} iterations, chunked sums): "
        f"{time.perf_counter() - t0:.2f}s")
    bh = beta.cpu().numpy()
    say(f"recovered support: {int((np.abs(bh) > 1e-4).sum())} features "
        f"(true: {int((beta_true != 0).sum())})")
    return {"masks": res.masks, "same": same, "agree": agree, "beta": bh}


def _rank(rank: int, world: int, store_path: str, argv) -> None:
    """One gloo rank of a CPU run."""
    args = _args(argv)
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        q, f = _parse(args.mesh)
        run(init_device_mesh("cpu", (q, f),
                             mesh_dim_names=("query", "feature")),
            args, torch.device("cpu"))
    finally:
        dist.destroy_process_group()


def _parse(spec: str) -> tuple[int, int]:
    q, f = (int(t) for t in spec.lower().split("x"))
    return q, f


def main(argv=None):
    args = _args(argv)
    device = torch.device("cuda" if args.device is None else args.device)
    q, f = _parse(args.mesh)
    world = q * f
    if "WORLD_SIZE" in os.environ:          # under torchrun
        kw = {}
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                              "0")))
            torch.cuda.set_device(device)
            kw["device_id"] = device
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://", **kw)
    elif world > 1 and device.type == "cpu":
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(_rank, args=(world, os.path.join(tmp, "store"),
                                            argv), nprocs=world,
                               start_method="spawn")
        return None
    elif world > 1:
        raise SystemExit(f"--mesh {args.mesh} needs {world} processes, one "
                         f"per card: launch with torchrun "
                         f"--nproc-per-node={world}")
    else:
        kw = {}
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise SystemExit("no CUDA device: pass --device cpu")
            device = torch.device("cuda", torch.cuda.current_device())
            kw["device_id"] = device
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1,
                                **kw)
    try:
        return run(init_device_mesh(device.type, (q, f),
                                    mesh_dim_names=("query", "feature")),
                   args, device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
