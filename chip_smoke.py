#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (target: H100 SXM).

    python3 chip_smoke.py

Phases, each printing its own lines and seconds:

1. environment: the card's name and power limit (nvidia-smi), torch,
   and the TF32 flags the package sets;
2. build: nvcc builds the CUDA kernels from this checkout's sources;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the paper's MNIST-like 784 × 50 000 and SVHN-like 3072 × 99 288
   shapes (benchmarks/bench_sequential.py), narrow solver buckets and a
   ragged shape, with times (CUDA events, median of 20) beside the
   byte/flop bound and a torch.matmul yardstick;
4. main path: ``LassoSession.fit(X)`` then ``session.path(y,
   num_lambdas=100)`` with the default config at 784 × 50 000, with
   every kernel launch counter read just after and the plain versions'
   counters required to stay at 0;
5. exactness: the EDPP path against the unscreened path (tol 1e-6, 20 λ);
6. summary: one JSON line of per-kernel numbers, then, last,
   ``{"ok": true, "device": {...}}``.

Any failed phase raises and the script exits non-zero. It also exits
non-zero, printing no result, without a CUDA device or outside a checkout
of the repository (it imports the package from ``src/``).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 rate outside the tensor cores
REPS = 20
MNIST = (784, 50000)
SVHN = (3072, 99288)
REPLACES = {
    "edpp_screen_scores": "src/repro/kernels/edpp_screen.py:140",
    "screen_matvec": "src/repro/kernels/edpp_screen.py:202",
    "fista_step": "src/repro/kernels/solver_step.py:146",
}
SOURCES = {
    "edpp_screen_scores": "src/repro_torch/kernels/csrc/edpp_screen.cu",
    "screen_matvec": "src/repro_torch/kernels/csrc/edpp_screen.cu",
    "fista_step": "src/repro_torch/kernels/csrc/solver_step.cu",
}


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    print(f"== {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def make_dataset(n: int, p: int, seed: int = 0):
    """benchmarks/bench_sequential.make_dataset: Gaussian X, a 16-sparse
    Gaussian truth, noise 0.05."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    w = np.zeros(p)
    idx = rng.choice(p, 16, replace=False)
    w[idx] = rng.standard_normal(idx.size)
    y = X @ w + 0.05 * rng.standard_normal(n)
    return X.astype(np.float32), y.astype(np.float32)


def beta_err_tol(y, solver_tol: float, kappa: float = 25.0) -> float:
    """benchmarks/common.beta_err_tol: the gap between two paths that each
    stop at relative duality gap ``solver_tol``."""
    scale = 0.5 * float(np.asarray(y, np.float64) @ np.asarray(y, np.float64))
    return kappa * float(np.sqrt(solver_tol * scale))


def event_ms(torch, fn) -> float:
    """Median device time of ``fn`` over REPS runs, by CUDA events. A sleep
    kernel ahead of each run keeps the stream busy while the host enqueues
    it, so the interval holds device work only, not Python launch time."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(REPS):
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def bound(op: str, n: int, p: int, B: int) -> tuple[float, str]:
    """Least time on an H100 SXM: each input read once, each output written
    once, over 3.35 TB/s, against the flops over the float32 rate."""
    words = {"screen_matvec": n * p + B * n + B * p,
             "edpp_screen_scores": n * p + B * n + B * p + p,
             "fista_step": n * p + B * n + 4 * B * p}[op]
    flops = {"screen_matvec": 2 * B * n * p,
             "edpp_screen_scores": 2 * B * n * p + 2 * n * p + 3 * B * p,
             "fista_step": 2 * B * n * p + 6 * B * p}[op]
    t_bytes = 4.0 * words / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel(torch, kernels, ref, op: str, n: int, p: int, B: int,
                 seed: int) -> dict:
    """One case: the kernel against its plain version on the same inputs,
    then their times, the bound and the c @ X yardstick."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    X = rand(n, p)
    lead = () if B == 1 else (B,)
    c = rand(*lead, n)
    if op == "fista_step":
        z, bo = rand(*lead, p), rand(*lead, p)
        lam = torch.rand(B, generator=g, device="cuda") if B > 1 else 0.7
        step = 1.0 / (n + p)
        args = (X, c, z, bo, step, lam, 0.6)
        kern, plain = kernels.fista_step, ref.fista_step_ref
    elif op == "edpp_screen_scores":
        rho = torch.rand(B, generator=g, device="cuda") if B > 1 else 0.37
        args = (X, c, rho)
        kern, plain = kernels.edpp_screen_scores, ref.edpp_screen_ref
    else:
        args = (X, c)
        kern, plain = kernels.screen_matvec, ref.screen_matvec_ref
    out_k, out_p = kern(*args), plain(*args)
    torch.cuda.synchronize()
    if op == "screen_matvec":
        out_k, out_p = (out_k,), (out_p,)
    err, tol = 0.0, 0.0
    for a, b in zip(out_k, out_p):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        assert bool(torch.isfinite(a).all()), f"{op}: non-finite output"
        err = max(err, float((a - b).abs().max()))
        tol = max(tol, 2e-5 * max(1.0, float(b.abs().max())))
    ms = event_ms(torch, lambda: kern(*args))
    plain_ms = event_ms(torch, lambda: plain(*args))
    matmul_ms = event_ms(torch, lambda: torch.matmul(c, X))
    bound_ms, bound_by = bound(op, n, p, B)
    row = {"op": op, "n": n, "p": p, "B": B, "max_abs_err": err, "tol": tol,
           "ms": ms, "plain_ms": plain_ms, "matmul_ms": matmul_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"  {op:<19} {n}x{p} B={B}: max_abs_err={err:.3g} (tol {tol:.3g}) "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} matmul_ms={matmul_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) "
          f"{bound_ms / ms:.0%} of bound", flush=True)
    if not err <= tol:
        raise AssertionError(f"{op} {n}x{p} B={B}: kernel disagrees with its "
                             f"plain version: {err} > {tol}")
    del X, c, args, out_k, out_p
    torch.cuda.empty_cache()
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
    from repro_torch import kernels
    from repro_torch.kernels import build, ops, ref

    with phase("environment"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        print(smi)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)} "
              f"count {torch.cuda.device_count()}")
        print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
              f"cudnn={torch.backends.cudnn.allow_tf32} "
              f"package {repro_torch.__file__}")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32

    with phase("build"):
        t0 = time.perf_counter()
        logs = build.build_all()
        print(f"nvcc build of {sorted(logs)}: "
              f"{time.perf_counter() - t0:.2f} s")
        for name, log in logs.items():       # ptxas -v, one line per kernel
            regs = sorted({line.split("ptxas info    :")[-1].strip()
                           for line in log.splitlines() if "registers" in line})
            spills = sorted({line.strip() for line in log.splitlines()
                             if "spill" in line})
            print(f"  {name}: {regs}; {spills}")

    rows = {}
    with phase("kernels against their plain versions"):
        cases = [(op, *MNIST, B) for op in ("edpp_screen_scores",
                                            "screen_matvec") for B in (1, 8)]
        cases += [(op, *SVHN, 1) for op in ("edpp_screen_scores",
                                            "screen_matvec")]
        cases += [("fista_step", 784, p, B) for p in (32, 512, 4096)
                  for B in (1, 8)]
        cases += [(op, 777, 1001, 3) for op in ("edpp_screen_scores",
                                                "screen_matvec", "fista_step")]
        for i, case in enumerate(cases):
            rows[case] = check_kernel(torch, kernels, ref, *case, seed=i)

    X, y = make_dataset(*MNIST)
    n, p = MNIST
    with phase("main path: fit + 100-λ path, default config"):
        ops.reset_counts()
        t0 = time.perf_counter()
        sess = LassoSession.fit(X)
        res = sess.path(y, num_lambdas=100)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = ops.launch_counts(), ops.plain_counts()
        print(f"launches {launches} plain-version calls {plain}")
        assert all(v > 0 for v in launches.values()), launches
        assert not any(plain.values()), plain
        assert sess.geometry.X.is_cuda and sess.backend_name == "cuda"
        assert sess.fit_passes == 1, sess.fit_passes
        live = [s for s in res.stats if s.screen_backend]   # λ < λ_max
        assert live and all(s.x_passes == 1 for s in live)
        assert np.isfinite(res.betas).all()
        cfg = sess.config.solve
        at_max = sum(s.solver_iters >= cfg.max_iter for s in live)
        dec = [float(np.mean([s.n_discarded / p
                              for s in res.stats[k:k + 10]]))
               for k in range(0, 100, 10)]
        iters = sum(s.solver_iters for s in res.stats)
        print(f"path wall {wall:.2f} s; {len(live)} live steps, all at "
              f"x_passes=1; fit_passes={sess.fit_passes}; steps at "
              f"max_iter={cfg.max_iter} (tol {cfg.tol:g}): {at_max}; "
              f"solver iterations {iters}; query_converged "
              f"{bool(res.query_converged[0])}")
        print("discard fraction per decile of the grid: "
              + " ".join(f"{d:.4f}" for d in dec))
        by_bucket: dict[int, int] = {}
        for s in live:
            by_bucket[s.bucket] = by_bucket.get(s.bucket, 0) + s.solver_iters
        print(f"solver iterations per bucket: {dict(sorted(by_bucket.items()))}")
        main_bucket = max(by_bucket, key=by_bucket.get)
        main_launches = dict(launches)

    with phase("exactness: EDPP vs unscreened, tol 1e-6, 20 λ"):
        solve = SolveSpec(tol=1e-6)
        arms = {}
        for rule in ("edpp", "none"):
            sess.reset_solver_cache()
            t0 = time.perf_counter()
            arms[rule] = sess.path(
                y, num_lambdas=20, hi_frac=0.95,
                config=PathConfig(screen=ScreenSpec(rule=rule), solve=solve))
            at_max = sum(s.solver_iters >= solve.max_iter
                         for s in arms[rule].stats)
            print(f"  {rule}: {time.perf_counter() - t0:.2f} s, "
                  f"converged {bool(arms[rule].query_converged[0])}, "
                  f"steps at max_iter {at_max}")
        b_e, b_n = arms["edpp"].betas[0], arms["none"].betas[0]
        err, tol = float(np.abs(b_e - b_n).max()), beta_err_tol(y, 1e-6)
        unsafe = int((arms["edpp"].masks[0]
                      & (np.abs(b_n) > 1e-6 * np.abs(b_n).max())).sum())
        print(f"max|beta_edpp - beta_none| = {err:.3g} (tol {tol:.3g}); "
              f"unsafe discards {unsafe}; mean discard fraction "
              f"{arms['edpp'].masks[0].mean():.4f}")
        assert err <= tol and unsafe == 0

    with phase(f"kernels at the main path's shapes (fista bucket "
               f"{main_bucket})"):
        rows["main_fista"] = check_kernel(torch, kernels, ref, "fista_step",
                                          n, main_bucket, 1, seed=99)
    summary = []
    for op, key in (("edpp_screen_scores", ("edpp_screen_scores", *MNIST, 1)),
                    ("screen_matvec", ("screen_matvec", *MNIST, 1)),
                    ("fista_step", "main_fista")):
        r = rows[key]
        summary.append({
            "name": op, "route": "cuda", "source": SOURCES[op],
            "replaces": REPLACES[op], "launches": main_launches[op],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # torch.matmul(c, X) computes screen_matvec's function exactly;
            # the other two have no single library call
            "library_ms": r["matmul_ms"] if op == "screen_matvec" else None})
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
