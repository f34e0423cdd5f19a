"""Lasso path-solving entry point, the reference's
``src/repro/launch/solve.py`` on the port's sessions.

    PYTHONPATH=src python -m repro_torch.launch.solve --n 150 --p 3000 \\
        --rule edpp --num-lambdas 100 [--group-size 5] [--ckpt-dir DIR]

One :class:`repro_torch.LassoSession` is fitted per run (the fused
workspace pass over X happens exactly once) and the path is solved
through ``session.path``; group mode is ``fit(..., groups=m)``.
Checkpoints (λ_k, β_k) per grid point (:mod:`repro_torch.checkpoint`).

It runs on the card unless ``--device cpu`` is given. Precision follows
the device: float32 on the card, float64 (``--x64``, the reference's
default) on the CPU, where the plain versions solve it; ``--no-x64``
runs float32 on the CPU too, and ``--x64`` on the card exits.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..checkpoint import save
from ..core import LassoSession
from ..data import group_lasso_problem, lasso_problem
from . import cli


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    cli.add_problem_args(ap, n=150, p=3000, nnz=60)
    cli.add_engine_args(ap)
    cli.add_mesh_arg(ap)
    cli.add_x64_arg(ap, default=None)
    cli.add_device_arg(ap)
    ap.add_argument("--num-lambdas", type=int, default=100)
    ap.add_argument("--group-size", type=int, default=0,
                    help=">0 switches to group Lasso with this group size")
    ap.add_argument("--ckpt-dir", default="")
    return ap.parse_args(argv)


def main(argv=None):
    """Solve one path and print its summary. Returns the squeezed
    :class:`~repro_torch.PathResult`."""
    args = _parse_args(argv)
    device = cli.setup_device(args)
    dtype = np.float64 if args.x64 else np.float32

    groups = args.group_size if args.group_size > 0 else None
    ckpt_fn = None
    if args.ckpt_dir and cli.is_main_process():
        def ckpt_fn(k, lam, beta):
            save(args.ckpt_dir, k, {"beta": torch.from_numpy(
                np.asarray(beta, dtype=dtype))}, extra={"lam": lam})
    if groups:
        m = args.group_size
        X, y, _ = group_lasso_problem(args.n, args.p, m,
                                      active_groups=args.nnz // m + 1,
                                      dtype=dtype)
        if args.solver == "fista":     # the plain-Lasso default
            args.solver = "group_fista"
        elif not args.solver.startswith("group"):
            # a plain-l1 strategy would minimise the wrong objective under
            # the group penalty (and group-EDPP's safety assumes the l2,1
            # solution): refuse rather than silently mis-solve
            raise SystemExit(
                f"--group-size needs a group solver strategy "
                f"(got {args.solver!r}); use group_fista or a registered "
                f"group_* strategy")
    else:
        X, y, _ = lasso_problem(args.n, args.p, nnz=args.nnz,
                                corr=args.corr, dtype=dtype)

    cfg = cli.path_config(args, checkpoint_fn=ckpt_fn)
    with cli.mesh_world(args, device) as mesh:
        # float64 stays float64 only as a tensor (the session makes float64
        # numpy float32, as jnp.asarray does without x64)
        sess = LassoSession.fit(torch.from_numpy(X) if args.x64 else X,
                                groups=groups, mesh=mesh, config=cfg,
                                device=device)
        t0 = time.perf_counter()
        res = sess.path(y, num_lambdas=args.num_lambdas).squeeze()
        dt = time.perf_counter() - t0
        if cli.is_main_process():
            _print_summary(args, cfg, sess, res, dt)
    return res


def _print_summary(args, cfg, sess, res, dt: float) -> None:
    lmax = float(res.lambdas[0])      # grid starts at λ_max (hi_frac=1)
    strategy = cfg.solve.resolved_strategy(sess.groups)
    print(f"rule={args.rule} solver={strategy} "
          f"grid={args.num_lambdas} λmax={lmax:.3f}")
    print(f"path time {dt:.2f}s (screen {res.total_screen_time:.3f}s); "
          f"dictionary fitted once (fused passes: {sess.fit_passes})")
    if cfg.solve.solve_dtype != "float32":
        lo = sum(s.solver_lo_iters for s in res.stats)
        it = sum(s.solver_iters for s in res.stats)
        eff = next((s.solve_dtype_effective for s in res.stats
                    if s.solver_iters > 0), "float32")
        print(f"solve dtype {cfg.solve.solve_dtype} (effective {eff}): "
              f"{lo}/{it} iterations on the low-precision stream")
    K = len(res.lambdas)
    for k in range(0, K, max(K // 10, 1)):
        s = res.stats[k]
        print(f"  λ/λmax={s.lam/lmax:5.2f} discarded={s.n_discarded:7d} "
              f"kept={s.n_kept:6d} iters={s.solver_iters}")


if __name__ == "__main__":
    main()
