"""Quickstart on the PyTorch port: safe Lasso screening with EDPP.

Fits ONE :class:`repro_torch.LassoSession` on a synthetic problem (paper
eq. 74) — the fused dictionary-fit pass over X runs exactly once — then
solves the same λ-path twice through ``session.path``: without screening
and with sequential EDPP. Prints per-λ rejection ratios and the
end-to-end speedup.

    PYTHONPATH=src python examples/quickstart_torch.py [--quick] \\
        [--device cpu]

It runs on the GPU unless ``--device cpu`` is given. On the CPU the
problem stays float64 and the solver's relative gap tolerance is 1e-10,
as in ``examples/quickstart.py``; on the card the kernels take float32,
whose duality gap certifies 1e-6 and not much less. ``--quick`` shrinks
the problem for smoke runs.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
from repro_torch.data import lasso_problem


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small shapes for smoke runs")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    on_cpu = args.device is not None and torch.device(args.device).type == "cpu"

    n, p, nnz, K = (60, 400, 12, 12) if args.quick else (150, 3000, 60, 100)
    print(f"synthetic lasso: X is {n}x{p}, {nnz} true nonzeros (eq. 74)")
    X, y, _ = lasso_problem(n, p, nnz=nnz, corr=0.5, sigma=0.1,
                            dtype=np.float64 if on_cpu else np.float32)
    tol = 1e-10 if on_cpu else 1e-6
    # a float64 tensor stays float64 (the plain versions solve it); host
    # float64 arrays would become float32
    Xt = torch.from_numpy(X) if on_cpu else X

    # ONE session: the dictionary side (‖x_j‖², column norms, Lipschitz
    # cache) is fitted once and shared by both path runs below.
    sess = LassoSession.fit(Xt, device=args.device, config=PathConfig(
        screen=ScreenSpec(rule="edpp"), solve=SolveSpec(tol=tol)))
    plain = PathConfig(screen=ScreenSpec(rule="none"),
                       solve=SolveSpec(tol=tol))

    # warm-up: the kernels' build and first launches stay out of the timing
    sess.path(y, num_lambdas=4, config=plain)
    sess.path(y, num_lambdas=4)

    t0 = time.perf_counter()
    ref = sess.path(y, num_lambdas=K, config=plain).squeeze()
    t_plain = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = sess.path(y, num_lambdas=K).squeeze()
    t_edpp = time.perf_counter() - t0

    assert sess.fit_passes == 1, "dictionary must be fitted exactly once"
    lmax = float(res.lambdas[0])

    err = np.abs(res.betas - ref.betas).max()
    print(f"\nbackend {sess.backend_name}, {X.dtype} on "
          f"{sess.device.type}, solver tol {tol:g}")
    print(f"max |beta_screened - beta_plain| = {err:.2e}  (safe: exact)")
    print(f"unscreened path : {t_plain:6.2f}s")
    print(f"EDPP path       : {t_edpp:6.2f}s   speedup {t_plain/t_edpp:5.1f}x")
    print(f"screening cost  : {res.total_screen_time:6.3f}s")
    print(f"dictionary fit  : once per session "
          f"(fused passes: {sess.fit_passes}, "
          f"query attaches: {sess.query_passes})\n")

    print("  λ/λmax   discarded     kept  rejection-ratio")
    for k in range(0, K, max(K // 10, 1)):
        s = res.stats[k]
        nz = int((np.abs(ref.betas[k]) <= 1e-9).sum())
        print(f"  {s.lam/lmax:6.2f}   {s.n_discarded:9d} {s.n_kept:8d}"
              f"  {s.n_discarded/max(nz,1):10.3f}")
    return res, ref


if __name__ == "__main__":
    main()
