#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (target: H100 SXM).

    python3 chip_smoke.py

Phases, each printing its own lines and seconds:

1. environment: the card's name and power limit (nvidia-smi), torch,
   and the TF32 flags the package sets;
2. build: nvcc builds the CUDA kernels from this checkout's sources, one
   nvcc per source, all at once;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the paper's MNIST-like 784 × 50 000 and SVHN-like 3072 × 99 288
   shapes (benchmarks/bench_sequential.py), narrow solver buckets and a
   ragged shape; the Gram CD sweep at buckets of 32, 256 and 1024
   columns for 1 and 8 queries (and 8 with a ``valid`` mask), each beside
   its chain bound (sweeps·p × the latency of one dependent step, timed
   on a one-warp kernel of ``csrc/cd_gram.cu`` that runs the step's
   arithmetic without loads); the group scores at the paper's
   250 × 200 000 group design (benchmarks/bench_group.py) for m = 5, 10,
   20 and 200 (a group wider than a tile) and at 777 × 1 000 (m = 5) and
   777 × 1 001 (m = 7, scalar loads), each with its launch plan; the
   prox step at p = 50 000 for 1 and 8 queries and a ragged p = 1 003 for
   3 queries with per-query parameters, and on a stack of 4 gradient
   parts with its parameters in a (3, B) device block at the same shapes
   (bit for bit its plain version; ``torch.sum`` over the parts beside
   it), each also per launch in a run of 25 launches from Python and
   replayed from a CUDA graph of 25, beside a 1-element ``zero_()``
   timed the same two ways; with times (CUDA events, median
   of 20) beside the byte/flop bound and a torch.matmul yardstick. For
   the three column-pass kernels each row also prints its launch plan
   (grid, block, cluster, vector width, staged rows), the registers and
   spills of the kernel it launches (``-Xptxas -v``), its share of the
   bound and its ratio to torch.matmul; ``fista_step`` prints the launch
   floor (a 1-element ``zero_()`` timed the same way) beside it, and is
   timed at 784 × 32 and 784 × 512 with the rows split over clusters of
   8, 4, 2 and 1 CTAs, in turns, on zero rows, and per launch in runs of
   back-to-back launches beside torch.matmul and ``zero_()``;
4. main path: ``LassoSession.fit(X)`` then ``session.path(y,
   num_lambdas=100)`` with the default config at 784 × 50 000, with
   every kernel launch counter read just after and the plain versions'
   counters required to stay at 0;
5. exactness: the EDPP path against the unscreened path (tol 1e-6, 20 λ);
6. CD path: the same data and session entry points with
   ``SolveSpec(strategy="cd", tol=1e-6)``, 100 λ: every solve converged
   before max_epochs, and β held against the FISTA EDPP path at the same
   tol (beta_err_tol and CD_REL_TOL·max|β_fista|);
7. group path: ``LassoSession.fit(X, groups=10)`` and group EDPP at tol
   1e-6, 100 λ, on the paper's 250 × 200 000 design with 20 000 groups;
8. group exactness: group EDPP and group strong against the unscreened
   group path on its grid at 250 × 20 000 (m = 10; the unscreened arm
   solves every column each iteration, so this phase runs at a tenth of
   the width): no unsafe group discard, β within beta_err_tol and
   GROUP_REL_TOL·max|β_none|;
9. distributed: a process group of one rank over NCCL (a HashStore, the
   card as its device) and a (1, 1) ``("query", "feature")`` mesh, on the
   784 × 50 000 data at full width: ``LassoSession.fit(X, mesh=mesh)``
   and a 100-λ path (tol 1e-6, hi_frac 0.95) against the unsharded
   session (masks, β, passes equal); ``lambda_max_d`` against the
   session's λ_max; the three single-query ``dist_edpp_screen*`` at
   0.5·λ_max from β = 0 against the engine's EDPP mask;
   ``dist_power_iteration`` against ‖X‖₂²; ``dist_fista`` ``"none"`` and
   ``"chunked"`` (FISTA_ITERS iterations at 0.3·λ_max, from β = 0 and
   from a dense start), each replayed from CUDA graphs and run eagerly
   (``capture=False``), with ms per iteration: captured β bit for bit
   the eager β, the modes against each other and an unsharded solve at
   tol 1e-8, and the pieces of one iteration of each mode timed in a
   graph; ``dist_fista_batched`` and ``dist_edpp_screen_batched`` at
   B = 8 against 8 single-query runs; the (8, n) batch of those queries
   through the mesh session against the unsharded session (masks,
   n_discarded, x_passes equal, max|Δβ| ≤ 1e-6·max|β|); the group is
   torn down after;
10. batched path: ``QueryStream(n=784, p=50 000, batch=8, nnz=16,
   sigma=0.05, seed=0)``, ``LassoSession.fit(X)`` then ``path(Y)`` with
   Y (8, n), 100 λ per query (``hi_frac=0.95``), EDPP, FISTA at tol 1e-6:
   against 8 single-query runs of the same session on the same grids
   (masks equal outside the ±1e-4 band of the threshold, band columns
   counted; β within beta_err_tol per query), ``screen_matvec`` launched
   at most once per live step plus the |Xᵀy| attach, the union bucket per
   decile and the batched wall beside the single runs' walls; the same
   batch with ``strategy="cd"`` (every step on ``cd_gram_sweep`` at B = 8
   with ``valid``, every solve converged, β within beta_err_tol and
   CD_REL_TOL·max|β| of the FISTA arm); and one EDPP screen at B = 12 (two
   launches), masks and dots bit for bit the 12 single-query screens.
   The group exactness phase also holds a (2, n) group batch bit for bit
   against its two single runs;
11. serve: ``repro_torch.launch.serve.main`` in-process, as a user runs
   ``python -m repro_torch.launch.serve``, at 784 × 50 000 (``--nnz 16
   --seed 0``, the stream's own σ), 44 queries of 16 λ (``--hi-frac 0.95
   --lo-frac 0.1 --solver-tol 1e-6``), ``--b-max 8 --deadline-ms 20
   --queue-cap 64 --max-in-flight 2``, ``--mode compare --repeats 1
   --check-masks 0`` with the bench JSON in a temporary directory: both
   arms serve 44 of 44 with 0 errors, every served mask equals the direct
   ``session.path`` call on its grid outside the ±1e-4 band of the
   threshold (the queries not bit for bit and their flips counted and
   printed), the fixed arm's trace is
   5 × (fill, 8/8) then (drain, 4/8) and the continuous arm's 5 × (fill,
   8/8) then (deadline or drain, 4/4) (``tail_reason``: the deadline is
   checked first); queries/sec, p50 and p99 of both arms and each
   kernel's launches are printed as readings. Then ``--solver cd --mode
   continuous`` on the same data: 0 errors, every live step whose union
   bucket has at most min(n, ``GRAM_BUCKET_MAX``) columns on
   ``cd_gram_sweep`` and every wider one on matvec CD (the Gram
   crossover), no ``fista_step``;
12. solve: ``repro_torch.launch.solve.main`` in-process at 784 × 50 000
   (``--no-x64``, 20 λ, the default tol 1e-8) with ``--ckpt-dir``: the
   latest checkpoint is step 19, holds the result's last β, and only the
   newest 3 steps are kept; then ``--group-size 10`` at 250 × 20 000,
   which launches ``group_screen_scores``;
13. summary: one JSON line of per-kernel numbers (with, for
   ``screen_matvec``, ``fista_step`` and ``cd_gram_sweep``, the batched
   path's launches and its B = 8 row at its own shapes, and for every
   kernel the serve and solve phases' launches), then, last,
   ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --kernels [--tree DIR]`` runs phases 1 to 3 only
and prints their rows as one JSON line; with ``--tree`` it imports the
package (and builds the kernels) of the checkout at DIR instead of this
one, so that two trees are timed in one call by the same code (the
plans, registers and cluster comparison print only where that tree has
them).

``python3 chip_smoke.py --faults`` runs phases 1 and 2 and then the
mutation check of phases 6, 8 and 9's ``dist_fista`` check: the sound arm
and arms whose kernel output is faulted on purpose (``FAULTS``), with
each check's readings and verdict; every faulted arm whose β the fault
moves must fail.

Each path phase sets every launch counter to 0 just before it and reads
them just after: each kernel the path runs must have launched, and no
plain version may have been called.

Any failed phase raises and the script exits non-zero. It also exits
non-zero, printing no result, without a CUDA device or outside a checkout
of the repository (it imports the package from ``src/``).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 rate outside the tensor cores
REPS = 20
RUN = 4          # back-to-back launches timed together (cluster_choice)
GRAPH_RUN = 25   # calls per timed run or graph (prox step, dist_fista pieces)
PARTS = 4        # dist_fista's n_chunks: the gradient parts prox_step sums
MNIST = (784, 50000)
SVHN = (3072, 99288)
GROUP_FULL = (250, 200000, 10)     # bench_group.py --full, n_g = 20 000
GROUP_EXACT = (250, 20000, 10)     # a tenth of the width, n_g = 2 000
CD_SWEEPS = 10
# The exactness phases' limits on max|Δβ|, relative to the largest entry
# of the path they are held against (PERF.md §6, PR 12: the readings of
# sound and faulted arms, ``--faults``, that they were set from)
CD_REL_TOL = 1e-4
GROUP_REL_TOL = 1e-2
# dist_fista: "chunked" against "none", max|Δβ| relative to max|β_none|
FISTA_REL_TOL = 1e-4
FISTA_ITERS = 500
POWER_ITERS = 30
REPLACES = {
    "edpp_screen_scores": "src/repro/kernels/edpp_screen.py:140",
    "screen_matvec": "src/repro/kernels/edpp_screen.py:202",
    "fista_step": "src/repro/kernels/solver_step.py:146",
    "cd_gram_sweep": "src/repro/kernels/solver_step.py:251",
    "group_screen_scores": "src/repro/kernels/group_screen.py:68",
    "prox_step": "src/repro/kernels/prox_step.py:67",
}
SOURCES = {
    "edpp_screen_scores": "src/repro_torch/kernels/csrc/edpp_screen.cu",
    "screen_matvec": "src/repro_torch/kernels/csrc/edpp_screen.cu",
    "fista_step": "src/repro_torch/kernels/csrc/solver_step.cu",
    "cd_gram_sweep": "src/repro_torch/kernels/csrc/cd_gram.cu",
    "group_screen_scores": "src/repro_torch/kernels/csrc/group_screen.cu",
    "prox_step": "src/repro_torch/kernels/csrc/prox_step.cu",
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


def event_ms(torch, fn, reps: int = REPS) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events. A
    sleep kernel ahead of each run keeps the stream busy while the host
    enqueues it, so the interval holds device work only, not Python
    launch time."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def run_ms(torch, fn, k: int) -> float:
    """ms per call of ``fn`` in a run of ``k`` back-to-back calls launched
    from Python (what an eager loop pays), by :func:`event_ms`."""
    return event_ms(torch, lambda: [fn() for _ in range(k)]) / k


def graph_ms(torch, fn, k: int) -> float:
    """ms per call of ``fn`` replayed from a CUDA graph of ``k``
    back-to-back calls (one warm-up call on a side stream, then one
    capture), by :func:`event_ms` on the replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(k):
            fn()
    return event_ms(torch, graph.replay) / k


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


def cd_bound(p: int, B: int, sweeps: int,
             masked: bool) -> tuple[float, str]:
    """The Gram sweep's byte/flop bound: G, the (B, p) c and β (and
    ``valid`` when given) read once, β' written once, the B per-query λ
    read when B > 1 (one λ is passed by value), against
    2·B·(sweeps + 1)·p² flops (q₀ = βG and one rank-1 update of q per
    coordinate). Its real limit is the chain of sweeps·p dependent
    coordinate steps, printed beside it."""
    vectors = (4 if masked else 3) * B * p + (B if B > 1 else 0)
    t_bytes = 4.0 * (p * p + vectors) / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * B * (sweeps + 1) * p * p / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# The column pass's MODE template argument per op (csrc/colpass.cuh)
COLPASS_MODE = {"screen_matvec": 0, "edpp_screen_scores": 1, "fista_step": 2,
                "group_screen_scores": 3}
CHAIN_TURNS = 4096   # turns of 32 steps the chain kernel runs per launch


def chain_step_ns(torch, kernels) -> float | None:
    """The latency of one dependent coordinate step of the Gram sweep: the
    one-warp ``cd_chain_f32`` kernel of ``csrc/cd_gram.cu`` runs
    CHAIN_TURNS turns of 32 steps (the sweep's own ``turn``: the update,
    the IEEE division, the shuffle broadcast, the rank-1 update of q) on
    values in registers, timed by CUDA events (median of 5). None for a
    tree without that kernel."""
    try:
        fn = kernels.edpp_screen.kernel_fn("cd_gram", "cd_chain_f32")
    except (AttributeError, KeyError):
        return None
    out = torch.empty(32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(CHAIN_TURNS, 32, 0.1, 2.0, out.data_ptr(), stream)
        assert err == 0, f"cd_chain_f32: cudaError_t {err}"
    ms = event_ms(torch, run, reps=5)
    assert bool(torch.isfinite(out).all())
    return ms * 1e6 / (CHAIN_TURNS * 32)


def ptxas_table(logs: dict[str, str]) -> dict[str, tuple[int, int, int]]:
    """Registers and spill bytes (stores, loads) of every kernel in the
    build's ``-Xptxas -v`` logs, by mangled name."""
    table, fn, spills = {}, None, (0, 0)
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn, spills = m.group(1), (0, 0)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spills = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                table[fn] = (int(m.group(1)), *spills)
    return table


def kernel_ptxas(table: dict, key: str) -> str:
    """The registers and spills of the kernel whose mangled name holds
    ``key``."""
    hits = [v for k, v in table.items() if key in k]
    if not hits:
        return "ptxas n/a (libraries not rebuilt here)"
    regs, st, ld = hits[0]
    return f"{regs} registers, spills {st}/{ld} bytes (stores/loads)"


def colpass_ptxas(table: dict, op: str, nb: int, vec: int) -> str:
    """The registers and spills of the column-pass instantiation that a
    launch of ``op`` with ``nb`` queries and loads of width ``vec`` runs."""
    return kernel_ptxas(table, f"colpass_kernelILi{COLPASS_MODE[op]}ELi{nb}"
                               f"ELb{int(vec == 4)}E")


def plan_line(kernels, X, B: int, op: str, ptxas: dict) -> str:
    """The launch plan of a column-pass kernel on X for B queries, with the
    registers and spills of the kernel it runs; 'n/a' for a tree whose
    wrappers choose no plan."""
    plan_for = getattr(kernels.edpp_screen, "plan_for", None)
    if plan_for is None:
        return "plan n/a"
    pl = plan_for(X, min(B, kernels.edpp_screen.MAX_B))
    return (f"plan grid={pl.grid} block={pl.block} cluster={pl.split} "
            f"vec={pl.vec} tile={pl.tile} stage_rows={pl.stage_rows} "
            f"smem={pl.smem} B; "
            f"{colpass_ptxas(ptxas, op, min(B, 8), pl.vec)}")


def check_cd(torch, kernels, ref, p: int, B: int, seed: int,
             masked: bool = False, step_ns: float | None = None,
             ptxas: dict | None = None) -> dict:
    """The Gram CD sweep (CD_SWEEPS sweeps) against its plain version:
    the reference's case, G = AᵀA with three zero columns, c = 0.1·rG,
    a small warm start, λ = ½·max|c| per query. Tolerance, elementwise:
    2e-5 + 2e-4·|plain| (the reference's own for this sweep: a rounding
    difference in q₀ propagates along the chain). Beside the byte/flop
    bound, the chain bound: CD_SWEEPS·p steps × ``step_ns``, the
    latency of one step (``chain_step_ns``), with the registers and
    spills of the kernel the launch runs."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(2 * p, p, generator=g, device="cuda")
    A[:, -3:] = 0.0
    G = A.T @ A
    G = 0.5 * (G + G.T)                  # exactly symmetric
    lead = () if B == 1 else (B,)
    c = 0.1 * (torch.randn(*lead, p, generator=g, device="cuda") @ G)
    beta = 0.1 * torch.randn(*lead, p, generator=g, device="cuda")
    valid = None
    if masked:
        valid = (torch.rand(*lead, p, generator=g, device="cuda")
                 > 0.3).float()
        beta = beta * valid
    lam = 0.5 * c.abs().amax(-1) if B > 1 else 0.5 * float(c.abs().max())
    args = (G, c, beta, lam, CD_SWEEPS, valid)
    out_k = kernels.cd_gram_sweep(*args)
    out_p = ref.cd_gram_sweep_ref(*args)
    torch.cuda.synchronize()
    assert out_k.shape == out_p.shape and bool(torch.isfinite(out_k).all())
    err = float((out_k - out_p).abs().max())
    excess = float(((out_k - out_p).abs() - 2e-4 * out_p.abs()).max())
    ok = excess <= 2e-5 and not out_k[..., -3:].any() and (
        valid is None or not (out_k * (1 - valid)).any())
    ms = event_ms(torch, lambda: kernels.cd_gram_sweep(*args))
    plain_ms = event_ms(torch, lambda: ref.cd_gram_sweep_ref(*args), reps=3)
    bound_ms, bound_by = cd_bound(p, B, CD_SWEEPS, masked)
    steps = CD_SWEEPS * p
    chain_ms = None if step_ns is None else steps * step_ns * 1e-6
    which = "cd_warp_kernel" if p <= 32 else "cd_block_kernel"
    regs = kernel_ptxas(ptxas or {}, which)
    row = {"op": "cd_gram_sweep", "p": p, "B": B, "valid": masked,
           "max_abs_err": err, "tol": "2e-5 + 2e-4*|plain|", "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "chain_steps": steps, "ns_per_step": ms * 1e6 / steps,
           "chain_ms": chain_ms, "ptxas": f"{which}: {regs}"}
    chain = ("chain bound n/a" if chain_ms is None else
             f"chain bound {chain_ms:.4f} ms ({step_ns:.1f} ns/step), "
             f"kernel {ms / chain_ms:.2f}x it")
    print(f"  cd_gram_sweep       p={p} B={B} valid={masked} sweeps="
          f"{CD_SWEEPS}: max_abs_err={err:.3g} (2e-5 + 2e-4·|plain|) "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.6f} "
          f"({bound_by}); chain of {steps} steps, "
          f"{row['ns_per_step']:.1f} ns/step; {chain}\n      "
          f"{row['ptxas']}", flush=True)
    if not ok:
        raise AssertionError(f"cd_gram_sweep p={p} B={B}: kernel disagrees "
                             f"with its plain version (excess {excess})")
    return row


def group_plan_line(kernels, X, m: int, ptxas: dict) -> str:
    """The group pass's launch plan on X with the registers and spills of
    the kernel it runs; 'n/a' for a tree without a group plan."""
    plan_for = getattr(kernels.group_screen, "group_plan_for", None)
    if plan_for is None:
        return "plan n/a"
    pl = plan_for(X, m)
    return (f"plan grid={pl.grid} block={pl.block} cluster={pl.split} "
            f"vec={pl.vec} tile={pl.tile} steps={-(-pl.tile // 128)} "
            f"stage_rows={pl.stage_rows} smem={pl.smem} B; "
            f"{colpass_ptxas(ptxas, 'group_screen_scores', 1, pl.vec)}")


def check_group(torch, kernels, ref, n: int, p: int, m: int,
                seed: int, ptxas: dict | None = None) -> dict:
    """The group scores against their plain version; tolerance
    2e-5·max(1, max|plain|) (sums run in another order). Bound: the bytes
    of X (2 flops per element); yardstick c @ X, which computes the dots
    but not the group norms."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(n, p, generator=g, device="cuda")
    c = torch.randn(n, generator=g, device="cuda")
    out_k = kernels.group_screen_scores(X, c, m)
    out_p = ref.group_screen_ref(X, c, m)
    torch.cuda.synchronize()
    assert out_k.shape == out_p.shape == (p // m,)
    assert bool(torch.isfinite(out_k).all())
    err = float((out_k - out_p).abs().max())
    tol = 2e-5 * max(1.0, float(out_p.abs().max()))
    ms = event_ms(torch, lambda: kernels.group_screen_scores(X, c, m))
    plain_ms = event_ms(torch, lambda: ref.group_screen_ref(X, c, m))
    matmul_ms = event_ms(torch, lambda: torch.matmul(c, X))
    t_bytes = 4.0 * (n * p + n + p // m) / HBM_BYTES_PER_S * 1e3
    t_ops = (2.0 * n * p + 2.0 * p) / F32_FLOPS_PER_S * 1e3
    bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                          else (t_ops, "operations"))
    plan = group_plan_line(kernels, X, m, ptxas or {})
    row = {"op": "group_screen_scores", "n": n, "p": p, "m": m,
           "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
           "matmul_ms": matmul_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "of_bound": bound_ms / ms, "matmul_ratio": ms / matmul_ms,
           "plan": plan}
    print(f"  group_screen_scores {n}x{p} m={m}: max_abs_err={err:.3g} "
          f"(tol {tol:.3g}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"matmul_ms={matmul_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
          f"{bound_ms / ms:.0%} of bound, {ms / matmul_ms:.2f}x torch.matmul"
          f"\n      {plan}", flush=True)
    if not err <= tol:
        raise AssertionError(f"group_screen_scores {n}x{p} m={m}: kernel "
                             f"disagrees with its plain version: {err}")
    del X, c
    torch.cuda.empty_cache()
    return row


def prox_bound(p: int, B: int, parts: int = 1) -> tuple[float, str]:
    """The prox step's bound: z, β_old and the ``parts`` gradient parts
    read, β' and z' written, (parts + 4)·B·p·4 bytes, against
    (parts + 7)·B·p flops (the parts' sums, then 8 per element)."""
    t_bytes = 4.0 * (parts + 4) * B * p / HBM_BYTES_PER_S * 1e3
    t_ops = (parts + 7.0) * B * p / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_prox(torch, prox_step, ref, p: int, B: int, per_query: bool,
               seed: int, floors: dict, parts: int | None = None) -> dict:
    """The prox step against its plain version, timed alone, per launch
    in a run of GRAPH_RUN launches from Python and per launch replayed
    from a CUDA graph of GRAPH_RUN launches, beside the launch floors of
    the same kinds (``floors``). Bound: :func:`prox_bound`.

    With ``parts``, g is a (parts, B, p) stack of gradient parts and the
    parameters a (3, B) device block (the distributed FISTA's
    ``"chunked"`` call): bit for bit the plain version (the parts summed
    in index order, then the prox), with ``torch.sum`` over the parts
    beside it (the parts' sum alone: no library call computes the prox).
    Without, g is plain and the parameters host numbers or (B,) tensors:
    both round each product and difference alone, so they agree but for
    the threshold step·λ, which the plain version's scalar path rounds
    from host numbers: tolerance 1e-6·max(1, max|plain|); no library
    call computes it."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lead = () if B == 1 else (B,)
    z, b = (torch.randn(*lead, p, generator=g, device="cuda")
            for _ in range(2))
    if parts:
        stack = torch.randn(parts, *lead, p, generator=g, device="cuda")
        par = torch.stack([torch.full((B,), 1.0 / 65000, device="cuda"),
                           300.0 * torch.rand(B, generator=g, device="cuda"),
                           torch.rand(B, generator=g, device="cuda")])
        args, kw = (z, stack, b), {"params": par}
    else:
        grad = torch.randn(*lead, p, generator=g, device="cuda")
        if per_query:
            par = tuple(torch.rand(B, generator=g, device="cuda")
                        for _ in range(3))
        else:
            par = (1.0 / 65000, 300.0, 0.6)
        args, kw = (z, grad, b, *par), {}
    out_k, out_p = prox_step(*args, **kw), ref.prox_step_ref(*args, **kw)
    torch.cuda.synchronize()
    err, tol = 0.0, 0.0
    for a, w in zip(out_k, out_p):
        assert a.shape == w.shape == z.shape and bool(torch.isfinite(a).all())
        err = max(err, float((a - w).abs().max()))
        tol = max(tol, 0.0 if parts else 1e-6 * max(1.0, float(
            w.abs().max())))
    ms = event_ms(torch, lambda: prox_step(*args, **kw))
    in_run = run_ms(torch, lambda: prox_step(*args, **kw), GRAPH_RUN)
    in_graph = graph_ms(torch, lambda: prox_step(*args, **kw), GRAPH_RUN)
    plain_ms = event_ms(torch, lambda: ref.prox_step_ref(*args, **kw))
    library_ms = event_ms(torch, lambda: torch.sum(stack, 0)) if parts \
        else None
    bound_ms, bound_by = prox_bound(p, B, parts or 1)
    row = {"op": "prox_step", "p": p, "B": B, "per_query": per_query,
           "parts": parts, "max_abs_err": err, "tol": tol, "ms": ms,
           "run_ms": in_run, "graph_ms": in_graph, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, "floors": floors}
    library = ("none: no single call" if library_ms is None else
               f"{library_ms:.4f} (torch.sum over the parts)")
    print(f"  prox_step {parts or 'no'} parts p={p} B={B} per_query="
          f"{per_query}: max_abs_err={err:.3g} (tol {tol:.3g}) "
          f"ms={ms:.4f} per launch in a run of {GRAPH_RUN} "
          f"{in_run:.4f} (zero_ {floors['run']:.4f}), in a graph "
          f"{in_graph:.4f} (zero_ {floors['graph']:.4f}) plain_ms="
          f"{plain_ms:.4f} bound_ms={bound_ms:.6f} ({bound_by}); "
          f"library_ms {library}", flush=True)
    if not err <= tol:
        raise AssertionError(f"prox_step {parts} parts p={p} B={B}: kernel "
                             f"disagrees with its plain version: {err} > "
                             f"{tol}")
    return row


@contextlib.contextmanager
def nccl_world(torch):
    """A process group of one rank over NCCL on card 0 (a HashStore: no
    address, no port) and its (1, 1) ("query", "feature") mesh; the group
    is torn down on exit. An NCCL failure fails the phase."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0,
                             world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("query", "feature"))
    finally:
        tdist.destroy_process_group()


def fista_readings(torch, D, mesh, Xl, yt, lam: float, L: float, beta0,
                   beta_solve) -> dict:
    """What the dist_fista check reads: FISTA_ITERS iterations of "none"
    and "chunked" from beta0, each replayed from CUDA graphs (the default)
    and with ``capture=False`` (keys ``<mode>_eager``); whether the two
    gave the same bits; max|β_chunked − β_none| relative to max|β_none|,
    and each mode's max|Δβ| to the unsharded solve, with the kernel
    launches and seconds of each run."""
    from repro_torch.kernels import ops
    out, betas = {}, {}
    for mode in ("none", "chunked"):
        for key, capture in ((mode, True), (f"{mode}_eager", False)):
            ops.reset_counts()
            t0 = time.perf_counter()
            betas[key] = D.dist_fista(mesh, Xl, yt, lam, beta0, L,
                                      iters=FISTA_ITERS, overlap=mode,
                                      capture=capture)
            torch.cuda.synchronize()
            out[f"{key}_s"] = time.perf_counter() - t0
            out[f"{key}_launches"] = ops.launch_counts()
            assert not any(ops.plain_counts().values()), ops.plain_counts()
    b_n, b_c = betas["none"], betas["chunked"]
    scale = float(b_n.abs().max())
    return dict(out, rel=float((b_c - b_n).abs().max()) / max(scale, 1e-30),
                err_none=float((b_n - beta_solve).abs().max()),
                err_chunked=float((b_c - beta_solve).abs().max()),
                scale=scale, bits_equal={
                    m: torch.equal(betas[m], betas[f"{m}_eager"])
                    for m in ("none", "chunked")})


def fista_failures(r: dict, y) -> list[str]:
    """The dist_fista check: "chunked" within FISTA_REL_TOL·max|β_none| of
    "none", both within beta_err_tol of the unsharded solve, the
    captured runs bit for bit the eager ones, and each run's kernel
    launched once per iteration."""
    fails = []
    if not r["rel"] <= FISTA_REL_TOL:
        fails.append(f"chunked vs none {r['rel']:.3g} > {FISTA_REL_TOL:g}")
    for mode, op in (("none", "fista_step"), ("chunked", "prox_step")):
        if not r[f"err_{mode}"] <= beta_err_tol(y, 1e-6):
            fails.append(f"{mode} vs the solve > beta_err_tol")
        if not r["bits_equal"][mode]:
            fails.append(f"{mode}: captured beta differs from eager")
        for key in (mode, f"{mode}_eager"):
            if r[f"{key}_launches"][op] != FISTA_ITERS:
                fails.append(f"{key}: {op} not once per iteration")
    return fails


def fista_breakdown(torch, D, mesh, Xl, yt) -> dict:
    """ms per iteration of each piece of a dist_fista iteration, each
    replayed from a CUDA graph of GRAPH_RUN repetitions at the path's
    shapes: "none" = the fit X_b z, its n-vector SUM, the fused
    fista_step; "chunked" = the PARTS chunk fits, their PARTS async SUMs
    (with the waits), the PARTS gradient products X_cᵀ(f − y_c) and the
    prox on the stack. The parameters sit in a (3, 1) device block."""
    from repro_torch.kernels import ops
    SUM = torch.distributed.ReduceOp.SUM
    n, p = Xl.shape
    group = D._feature(mesh)[0]
    z = 0.01 * torch.randn(p, generator=torch.Generator(device="cuda")
                           .manual_seed(7), device="cuda")
    par = torch.tensor([[1.0 / 65000], [300.0], [0.6]], device="cuda")
    chunk = -(-n // PARTS)
    bounds = [(lo, min(n, lo + chunk)) for lo in range(0, n, chunk)]
    fits = [Xl[lo:hi] @ z for lo, hi in bounds]
    parts = torch.empty(len(bounds), p, device="cuda")
    r = Xl @ z - yt
    vec = torch.zeros(n, device="cuda")

    def reduce_chunks():
        works = [D._reduce(f, group, SUM, async_op=True)
                 for f in fits]
        for w in works:
            w.wait()

    def products():
        for c, (lo, hi) in enumerate(bounds):
            torch.matmul(Xl[lo:hi].T, fits[c] - yt[lo:hi], out=parts[c])

    pieces = {
        "none": {"fit": lambda: Xl @ z,
                 "sum": lambda: D._reduce(vec, group, SUM),
                 "fista_step": lambda: ops.BACKENDS["cuda"].fista_step(
                     Xl, r, z, z, params=par)},
        "chunked": {"fits": lambda: [Xl[lo:hi] @ z for lo, hi in bounds],
                    "sums": reduce_chunks, "products": products,
                    "prox": lambda: ops.BACKENDS["cuda"].prox_step(
                        z, parts, z, params=par)}}
    out = {mode: {k: graph_ms(torch, fn, GRAPH_RUN) for k, fn in ps.items()}
           for mode, ps in pieces.items()}
    t_bytes = 4.0 * 2 * n * p / HBM_BYTES_PER_S * 1e3
    print(f"  dist_fista pieces, ms per iteration replayed from a graph of "
          f"{GRAPH_RUN} (X read twice an iteration: byte bound "
          f"{t_bytes:.4f} ms): " + "; ".join(
              f"{mode}: " + ", ".join(f"{k} {v:.4f}" for k, v in ps.items())
              + f" (sum {sum(ps.values()):.4f})" for mode, ps in out.items()),
          flush=True)
    return dict(out, bound_ms=t_bytes)


BLOCKS = (1, 5, 10, 25, 50)     # iterations per captured block, swept


def block_sweep(torch, D, mesh, Xl, yt, lam: float, L: float, beta0) -> dict:
    """ms per iteration of FISTA_ITERS captured iterations of "none" and
    "chunked" from beta0 with each block size of BLOCKS (the capture's
    eager prefix, its capture and the replays all inside the wall), each
    run's β bit for bit the eager run's."""
    from repro_torch.core import graphs
    out = {}
    for mode in ("none", "chunked"):
        want = D.dist_fista(mesh, Xl, yt, lam, beta0, L, iters=FISTA_ITERS,
                            overlap=mode, capture=False)
        out[mode] = {}
        for k in BLOCKS:
            graphs.BLOCK, default = k, graphs.BLOCK
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                beta = D.dist_fista(mesh, Xl, yt, lam, beta0, L,
                                    iters=FISTA_ITERS, overlap=mode)
                torch.cuda.synchronize()
                out[mode][k] = (time.perf_counter() - t0) / FISTA_ITERS * 1e3
            finally:
                graphs.BLOCK = default
            assert torch.equal(beta, want), (mode, k)
    print(f"  dist_fista ms per iteration by block size {BLOCKS} (default "
          f"{graphs.BLOCK}), captured bits equal to eager at each: "
          + "; ".join(f"{mode} " + ", ".join(f"{k}: {v:.4f}"
                                             for k, v in ms.items())
                      for mode, ms in out.items()), flush=True)
    return out


def fista_problem(torch, D, mesh, X, y):
    """The dist_fista check's set-up on the mesh: X's block and y, L =
    1.05 × the power iteration, λ = 0.3·λ_max (``lambda_max_d``), the
    unsharded FISTA solve at tol 1e-8 on the whole X, and the two starts
    (β = 0; a dense 0.01·N(0, 1) from a CPU generator seeded 0)."""
    from repro_torch.core import SolverEngine
    Xl, yt = D.shard_problem(mesh, X, y)
    L = 1.05 * float(D.dist_power_iteration(mesh, Xl, POWER_ITERS))
    lam = 0.3 * float(D.make_dist_ops(mesh)[0](Xl, yt))
    solve = SolverEngine(yt, tol=1e-8).solve(Xl, lam)
    p = X.shape[1]
    dense = 0.01 * torch.randn(p, generator=torch.Generator().manual_seed(0))
    starts = {"zero": torch.zeros(p, device=Xl.device),
              "dense": D.place_features(mesh, dense)}
    return Xl, yt, L, lam, solve.beta, starts


def counted(ops, needed: tuple[str, ...]) -> dict:
    """The launch counts read just after a path (set to 0 just before it):
    every kernel in ``needed`` launched, no plain version was called."""
    launches, plain = ops.launch_counts(), ops.plain_counts()
    print(f"launches {launches} plain-version calls {plain}")
    assert all(launches[k] > 0 for k in needed), (needed, launches)
    assert not any(plain.values()), plain
    return launches


def deciles(res, units: int) -> str:
    """The mean discard fraction over each tenth of the grid."""
    frac = [s.n_discarded / units for s in res.stats]
    step = max(1, len(frac) // 10)
    return " ".join(f"{np.mean(frac[k:k + step]):.4f}"
                    for k in range(0, len(frac), step))


def cd_readings(res_cd, res_fi, max_epochs: int) -> dict:
    """What the CD exactness check reads: whether every solve converged,
    the steps that ran out of epochs, max|β_cd − β_fista| and, beside it,
    max|β_fista|."""
    live = [s for s in res_cd.stats if s.screen_backend]
    return {"converged": bool(res_cd.query_converged[0]),
            "at_max_epochs": sum(s.solver_iters >= max_epochs for s in live),
            "err": float(np.abs(res_cd.betas - res_fi.betas).max()),
            "scale": float(np.abs(res_fi.betas).max())}


def cd_failures(r: dict, y) -> list[str]:
    """The CD path's check: every solve converged (none at max_epochs),
    and β within beta_err_tol and within CD_REL_TOL·max|β_fista| of the
    FISTA path."""
    fails = []
    if not r["converged"]:
        fails.append("a solve stopped above tol")
    if r["at_max_epochs"]:
        fails.append(f"{r['at_max_epochs']} steps at max_epochs")
    if r["err"] > beta_err_tol(y, 1e-6):
        fails.append("max|dbeta| > beta_err_tol")
    if r["err"] > CD_REL_TOL * r["scale"]:
        fails.append(f"max|dbeta| > {CD_REL_TOL:g}*max|beta_fista|")
    return fails


def group_readings(res, res_none, m: int) -> dict:
    """What the group exactness check reads against the unscreened arm:
    max|Δβ| beside max|β_none|, the discarded groups that the unscreened
    solution needs (norm above 1e-6·max|β_none|), the discard fraction
    and the KKT rounds."""
    b_n = res_none.betas[0]
    needed = (np.linalg.norm(b_n.reshape(b_n.shape[0], -1, m), axis=2)
              > 1e-6 * np.abs(b_n).max())
    return {"err": float(np.abs(res.betas[0] - b_n).max()),
            "scale": float(np.abs(b_n).max()),
            "unsafe": int((res.masks[0] & needed).sum()),
            "discard": float(res.masks[0].mean()),
            "kkt_rounds": sum(s.kkt_rounds for s in res.stats)}


def group_failures(r: dict, y) -> list[str]:
    """The group path's check: no unsafe group discard, and β within
    beta_err_tol and within GROUP_REL_TOL·max|β_none| of the unscreened
    arm."""
    fails = []
    if r["unsafe"]:
        fails.append(f"{r['unsafe']} unsafe group discards")
    if r["err"] > beta_err_tol(y, 1e-6):
        fails.append("max|dbeta| > beta_err_tol")
    if r["err"] > GROUP_REL_TOL * r["scale"]:
        fails.append(f"max|dbeta| > {GROUP_REL_TOL:g}*max|beta_none|")
    return fails


# Faults for the mutation check (``--faults``): each wraps the real kernel
# on the cuda backend the way a kernel bug would change its output.
def _cd_lam_high(real):
    """λ read 1 % high (another query's λ, say)."""
    return lambda G, c, beta, lam, sweeps=1, valid=None: real(
        G, c, beta, lam * 1.01, sweeps, valid)


def _cd_first_frozen(real):
    """The bucket's first coordinate never updated (an off-by-one in the
    coordinate loop)."""
    def sweep(G, c, beta, lam, sweeps=1, valid=None):
        out = real(G, c, beta, lam, sweeps, valid)
        out[..., 0] = beta[..., 0]
        return out
    return sweep


def _cd_bf16_gram(real):
    """G read at bfloat16 precision."""
    return lambda G, c, beta, lam, sweeps=1, valid=None: real(
        G.bfloat16().float(), c, beta, lam, sweeps, valid)


def _group_scaled(factor):
    """Every group score scaled by ``factor`` (a square left out of the
    sum, say)."""
    return lambda real: lambda X, c, m: factor * real(X, c, m)


def _group_shifted(real):
    """Group g's score written to g + 1 (an off-by-one in the output)."""
    return lambda X, c, m: real(X, c, m).roll(1)


def _prox_threshold_high(real):
    """The threshold step·λ 1 % high (λ read from the wrong query, say)."""
    def prox(z, g, b, step=None, lam=None, mom=None, *, params=None):
        if params is not None:
            params = params.clone()
            params[1] *= 1.01
        else:
            lam = lam * 1.01
        return real(z, g, b, step, lam, mom, params=params)
    return prox


def _prox_tail_unwritten(real):
    """The last 1 % of columns left unwritten (a grid that stops short):
    β' and z' keep β_old and z there."""
    def prox(z, g, b, *args, **kw):
        bn, zn = real(z, g, b, *args, **kw)
        k = max(1, z.shape[-1] // 100)
        bn[..., -k:] = b[..., -k:]
        zn[..., -k:] = z[..., -k:]
        return bn, zn
    return prox


FAULTS = {
    "cd_gram_sweep": (("lambda 1% high", _cd_lam_high),
                      ("first coordinate frozen", _cd_first_frozen),
                      ("G read at bf16", _cd_bf16_gram)),
    "group_scores": (("scores 5% low", _group_scaled(0.95)),
                     ("scores 20% low", _group_scaled(0.8)),
                     ("score of g written to g+1", _group_shifted)),
    "prox_step": (("threshold step*lambda 1% high", _prox_threshold_high),
                  ("last 1% of columns unwritten", _prox_tail_unwritten)),
}


@contextlib.contextmanager
def faulted(ops, field: str, make):
    """The cuda backend with ``field`` wrapped by ``make`` (none: sound)."""
    sound = ops.BACKENDS["cuda"]
    if make is not None:
        ops.BACKENDS["cuda"] = sound._replace(
            **{field: make(getattr(sound, field))})
    try:
        yield
    finally:
        ops.BACKENDS["cuda"] = sound


def fault_check(torch) -> list[dict]:
    """The mutation check of the CD and group exactness phases and of the
    dist_fista check: the sound arm and each fault of FAULTS run the
    check as the smoke run does, and their readings and failures are
    printed. Sound arms must pass, and every faulted arm that the fault
    harmed must fail its check: harmed means a solve that did not
    converge, a needed group discarded, or max|Δβ| (for dist_fista:
    chunked against none) over ten times the sound arm's. A fault may
    leave β as it was (a screen with room to spare; the KKT rounds behind
    group strong; a prox fault in columns that stay 0)."""
    from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
    from repro_torch.core import distributed as D
    from repro_torch.data import group_lasso_problem
    from repro_torch.kernels import ops

    arms = []

    def record(kind, fault, rule, run, readings, failures):
        try:
            r = readings(run())
            r["failures"] = failures(r)
        except Exception as e:          # a raise is a detection too
            r = {"failures": [f"raised {type(e).__name__}: {e}"]}
        r.update(kind=kind, fault=fault, rule=rule)
        print(f"  {kind} {rule} [{fault}]: {r}", flush=True)
        arms.append(r)

    X, y = make_dataset(*MNIST)
    with nccl_world(torch) as mesh:
        Xl, yt, L, lam, beta_solve, starts = fista_problem(torch, D, mesh, X,
                                                           y)
        for fault, make in (("sound", None), *FAULTS["prox_step"]):
            with faulted(ops, "prox_step", make):
                for start, beta0 in starts.items():
                    record("dist_fista", fault, start,
                           lambda: fista_readings(torch, D, mesh, Xl, yt,
                                                  lam, L, beta0, beta_solve),
                           lambda r: {k: v for k, v in r.items()},
                           lambda r: fista_failures(r, y))
        del Xl, yt, beta_solve, starts
    cd_cfg = PathConfig(solve=SolveSpec(strategy="cd", tol=1e-6))
    max_epochs = cd_cfg.solve.max_iter // 10 + 1
    res_fi = LassoSession.fit(X).path(y, num_lambdas=100, config=PathConfig(
        solve=SolveSpec(tol=1e-6)))
    for fault, make in (("sound", None), *FAULTS["cd_gram_sweep"]):
        with faulted(ops, "cd_gram_sweep", make):
            record("cd", fault, "edpp",
                   lambda: LassoSession.fit(X, config=cd_cfg).path(
                       y, num_lambdas=100),
                   lambda res: cd_readings(res, res_fi, max_epochs),
                   lambda r: cd_failures(r, y))

    n_e, p_e, m = GROUP_EXACT
    X, y, _ = group_lasso_problem(n_e, p_e, m, active_groups=20, seed=0,
                                  dtype=np.float32)
    solve = SolveSpec(tol=1e-6)
    res_none = LassoSession.fit(X, groups=m).path(
        y, num_lambdas=20, hi_frac=0.95,
        config=PathConfig(screen=ScreenSpec(rule="none"), solve=solve))
    grid = res_none.lambdas[0]
    for fault, make in (("sound", None), *FAULTS["group_scores"]):
        with faulted(ops, "group_scores", make):
            sess = LassoSession.fit(X, groups=m)
            for rule in ("edpp", "strong"):
                record("group", fault, rule,
                       lambda: sess.path(y, grid, config=PathConfig(
                           screen=ScreenSpec(rule=rule), solve=solve)),
                       lambda res: group_readings(res, res_none, m),
                       lambda r: group_failures(r, y))
    sound = {(r["kind"], r["rule"]): r for r in arms if r["fault"] == "sound"}
    for r in arms:
        s = sound[r["kind"], r["rule"]]
        key = "rel" if r["kind"] == "dist_fista" else "err"
        r["harmed"] = key not in r or (
            not r.get("converged", True) or r.get("unsafe", 0) > 0
            or r[key] > 10.0 * s[key])
    print(json.dumps({"faults": arms}), flush=True)
    for r in arms:
        if r["fault"] == "sound":
            assert not r["failures"], r
        elif r["harmed"]:
            assert r["failures"], f"fault not caught: {r}"
    return arms


def check_kernel(torch, kernels, ref, op: str, n: int, p: int, B: int,
                 seed: int, floor_ms: float, ptxas: dict,
                 block: bool = False) -> dict:
    """One case: the kernel against its plain version on the same inputs,
    then their times, the bound and the c @ X yardstick, with the launch
    plan and, for fista_step, the launch floor beside it. ``block``:
    fista_step takes its step | λ | mom as a ready (3, B) device block
    (``params=``), as the batched solver passes them, instead of a (B,)
    λ the wrapper stacks into one per call."""
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
        if block:
            par = torch.stack([torch.full((B,), step, device="cuda"), lam,
                               torch.full((B,), 0.6, device="cuda")])
            args = (X, c, z, bo)
            kern = functools.partial(kernels.fista_step, params=par)
            plain = functools.partial(ref.fista_step_ref, params=par)
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
    plan = plan_line(kernels, X, B, op, ptxas)
    row = {"op": op, "n": n, "p": p, "B": B, "params_block": block,
           "max_abs_err": err, "tol": tol,
           "ms": ms, "plain_ms": plain_ms, "matmul_ms": matmul_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "of_bound": bound_ms / ms, "matmul_ratio": ms / matmul_ms,
           "floor_ms": floor_ms, "plan": plan}
    floor = (f"; launch floor {floor_ms:.4f} ms ({ms / floor_ms:.2f}x)"
             if op == "fista_step" else "")
    print(f"  {op:<19} {n}x{p} B={B}{' params=(3, B)' if block else ''}: "
          f"max_abs_err={err:.3g} (tol {tol:.3g}) "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} matmul_ms={matmul_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) "
          f"{bound_ms / ms:.0%} of bound, {ms / matmul_ms:.2f}x torch.matmul"
          f"{floor}\n      {plan}", flush=True)
    if not err <= tol:
        raise AssertionError(f"{op} {n}x{p} B={B}: kernel disagrees with its "
                             f"plain version: {err} > {tol}")
    del X, c, args, out_k, out_p
    torch.cuda.empty_cache()
    return row


def cluster_choice(torch, kernels, ref, n: int, p: int, B: int,
                   seed: int) -> dict | None:
    """fista_step at (n, p, B) with its plan's tiles and the rows split over
    clusters of 8, 4 and 2 CTAs and over none (``max_split``), timed in
    turns (8, 4, 2, 1, 1, 2, 4, 8) on the same inputs, each held against
    the plain version (2e-5 of scale); each plan on no rows, its fixed
    cost; and, per launch, runs of RUN back-to-back launches of the plan,
    of ``torch.matmul(r, X)`` and of a 1-element ``zero_()`` (a loop's
    cost, which a single timed launch overstates). None for a tree whose
    wrappers choose no plan."""
    es = kernels.edpp_screen
    if not hasattr(es, "launch_plan"):
        return None
    g = torch.Generator(device="cuda").manual_seed(seed)
    lead = () if B == 1 else (B,)
    X = torch.randn(n, p, generator=g, device="cuda")
    r, z, bo = (torch.randn(*lead, k, generator=g, device="cuda")
                for k in (n, p, p))
    args = (X, r, z, bo, 1.0 / (n + p), 0.7, 0.6)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {k: es.launch_plan(n, p, B, sms, X.data_ptr() % 16 == 0,
                               max_split=k) for k in (8, 4, 2, 1)}
    want = ref.fista_step_ref(*args)
    tol = 2e-5 * max(1.0, max(float(w.abs().max()) for w in want))
    times = {k: [] for k in plans}
    for k in (8, 4, 2, 1, 1, 2, 4, 8):
        out = kernels.fista_step(*args, plan=plans[k])
        err = max(float((a - w).abs().max()) for a, w in zip(out, want))
        assert err <= tol, (k, err, tol)
        times[k].append(event_ms(
            torch, lambda: kernels.fista_step(*args, plan=plans[k])))
    # the fixed cost of each launch: the same plan on no rows (no loads,
    # no FMAs; the barriers, the cluster's sums and the epilogue remain)
    fixed = {k: event_ms(torch, lambda: kernels.fista_step(
        X[:0], r[..., :0], z, bo, 1.0 / (n + p), 0.7, 0.6,
        plan=plans[k]._replace(stage_rows=1))) for k in plans}
    # what a loop pays: ms per launch in a run of RUN back-to-back launches
    one = torch.zeros(1, device="cuda")
    run = {name: event_ms(torch, lambda: [fn() for _ in range(RUN)]) / RUN
           for name, fn in (("fista_step", lambda: kernels.fista_step(*args)),
                            ("torch.matmul", lambda: torch.matmul(r, X)),
                            ("zero_", lambda: one.zero_()))}
    chosen = es.plan_for(X, B).split
    print(f"  fista_step {n}x{p} B={B}, ms by cluster size (turns 8, 4, 2, "
          f"1, 1, 2, 4, 8; the plan takes {chosen}): "
          + "; ".join(f"{plans[k].split}: {times[k][0]:.4f} / "
                      f"{times[k][1]:.4f} (0 rows: {fixed[k]:.4f})"
                      for k in plans)
          + f"; ms per launch in runs of {RUN}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in run.items()), flush=True)
    return {"n": n, "p": p, "B": B, "chosen": chosen,
            "ms": {plans[k].split: times[k] for k in plans},
            "zero_rows_ms": {plans[k].split: fixed[k] for k in plans},
            "ms_per_launch_in_a_run": run}


def distributed_phase(torch, X, y) -> dict:
    """Phase 9 (see the module doc). Returns the launch counts of its
    chunked dist_fista runs (set to 0 just before them)."""
    from repro_torch import LassoSession, PathConfig, SolveSpec
    from repro_torch.core import ScreeningEngine
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops
    cfg = PathConfig(solve=SolveSpec(tol=1e-6))
    grid = dict(num_lambdas=100, hi_frac=0.95)
    with nccl_world(torch) as mesh:
        walls, res = {}, {}
        for arm in ("unsharded", "mesh", "mesh again", "unsharded again"):
            ops.reset_counts()
            t0 = time.perf_counter()
            sess = LassoSession.fit(X, config=cfg, mesh=mesh if "mesh" in arm
                                    else None)
            res[arm] = sess.path(y, **grid)
            torch.cuda.synchronize()
            walls[arm] = time.perf_counter() - t0
            counted(ops, ("edpp_screen_scores", "screen_matvec",
                          "fista_step"))
            if arm == "mesh":
                mesh_sess = sess
            elif arm == "unsharded":
                plain = sess
        print("path walls (100 λ, tol 1e-6): "
              + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()))
        r_u, r_m = res["unsharded"], res["mesh"]
        scale = float(np.abs(r_u.betas).max())
        d_beta = float(np.abs(r_m.betas - r_u.betas).max())
        same = [(a.x_passes, a.n_discarded) == (b.x_passes, b.n_discarded)
                for a, b in zip(r_m.stats, r_u.stats)]
        print(f"mesh session {mesh_sess.backend_name}: masks equal "
              f"{np.array_equal(r_m.masks, r_u.masks)}; max|dbeta| {d_beta:.3g}"
              f" (limit {1e-6 * scale:.3g}); x_passes and n_discarded equal "
              f"at {sum(same)} of {len(same)} steps; fit_passes "
              f"{mesh_sess.fit_passes}")
        assert mesh_sess.backend_name == "shard:cuda"
        assert mesh_sess.fit_passes == 1 and mesh_sess.X.is_cuda
        assert np.array_equal(r_m.masks, r_u.masks) and all(same)
        assert d_beta <= 1e-6 * scale

        ops.reset_counts()
        Xl, yt = D.shard_problem(mesh, X, y)
        lmd = D.make_dist_ops(mesh)[0]
        eng = ScreeningEngine(plain.X, yt, geometry=plain.geometry)
        lam_max = float(lmd(Xl, yt))
        print(f"lambda_max_d {lam_max!r}, session {eng.lam_max!r}")
        assert lam_max == eng.lam_max
        lam_next = 0.5 * lam_max
        mask_e = eng.screen(lam_next, eng.state_at_lambda_max(), "edpp")
        zero = torch.zeros(X.shape[1], device=Xl.device)
        norms = D.place_features(mesh, plain.geometry.col_norms)
        args = (lam_next, eng.lam_max, zero, eng.lam_max, eng.ws.v1_at_lmax)
        xstar = eng.ws.istar
        screens = {
            "dist_edpp_screen": D.dist_edpp_screen(mesh, Xl, yt, *args)[0],
            "dist_edpp_screen_cached": D.dist_edpp_screen_cached(
                mesh, Xl, yt, *args, norms)[1],
            "dist_edpp_screen_sparse": D.dist_edpp_screen_sparse(
                mesh, Xl, Xl[:, [xstar]], yt, lam_next, eng.lam_max,
                zero[[xstar]], eng.lam_max, eng.ws.v1_at_lmax, norms)[1]}
        for name, mask in screens.items():
            diff = int((D.gather_features(mesh, mask) != mask_e).sum())
            print(f"  {name} at 0.5·λ_max from β = 0: {int(mask.sum())} "
                  f"discarded, {diff} differ from the engine's EDPP mask")
            assert diff == 0, name

        t0 = time.perf_counter()
        power = float(D.dist_power_iteration(mesh, Xl, POWER_ITERS))
        torch.cuda.synchronize()
        power_s = time.perf_counter() - t0
        norm2 = float(torch.linalg.matrix_norm(plain.X, 2)) ** 2
        print(f"dist_power_iteration ({POWER_ITERS} iterations, "
              f"{power_s:.3f} s) {power:.6g}, ||X||_2^2 {norm2:.6g}, ratio "
              f"{power / norm2:.6f} (limits [1/1.05, 1 + 1e-5])")
        assert norm2 / 1.05 <= power <= norm2 * (1 + 1e-5)
        counted(ops, ("edpp_screen_scores", "screen_matvec"))

        ops.reset_counts()
        Xl, yt, L, lam, beta_solve, starts = fista_problem(torch, D, mesh, X,
                                                           y)
        counted(ops, ("screen_matvec", "fista_step"))
        fista = {}
        for start, beta0 in starts.items():
            fista[start] = r = fista_readings(torch, D, mesh, Xl, yt, lam, L,
                                              beta0, beta_solve)
            fails = fista_failures(r, y)
            per_iter = ", ".join(
                f"{key} {r[f'{key}_s'] / FISTA_ITERS * 1e3:.4f}"
                for key in ("none", "none_eager", "chunked", "chunked_eager"))
            print(f"  dist_fista from {start}, {FISTA_ITERS} iterations at "
                  f"0.3·λ_max, ms per iteration (captured; eager): "
                  f"{per_iter}; captured bits equal to eager "
                  f"{r['bits_equal']}; chunked vs none {r['rel']:.3g} of "
                  f"max|beta| {r['scale']:.4g} (limit {FISTA_REL_TOL:g}); vs "
                  f"the unsharded solve {r['err_none']:.3g} / "
                  f"{r['err_chunked']:.3g} (limit "
                  f"{beta_err_tol(y, 1e-6):.3g}); failures {fails}")
            assert not fails, fails
        fista_breakdown(torch, D, mesh, Xl, yt)
        block_sweep(torch, D, mesh, Xl, yt, lam, L, starts["zero"])
        launches = {"prox_step": sum(r[f"{key}_launches"]["prox_step"]
                                     for r in fista.values()
                                     for key in ("chunked", "chunked_eager"))}

        B = 8
        rng = np.random.default_rng(1)
        Y = [y]
        for _ in range(B - 1):
            w = np.zeros(X.shape[1], np.float32)
            idx = rng.choice(X.shape[1], 16, replace=False)
            w[idx] = rng.standard_normal(16)
            Y.append(X @ w + 0.05 * rng.standard_normal(X.shape[0]).astype(
                np.float32))
        Yq = D.place_queries(mesh, np.stack(Y))
        ops.reset_counts()
        dots = plain.geometry.backend.matvec(plain.X, Yq)
        istar = dots.abs().argmax(dim=1)
        lam_max_b = dots.abs().amax(dim=1)
        v1_b = torch.sign(dots[torch.arange(B), istar])[:, None] \
            * plain.X[:, istar].T
        zeros = torch.zeros(B, X.shape[1], device=Xl.device)
        mask_b, scores_b = D.dist_edpp_screen_batched(
            mesh, Xl, Yq, 0.5 * lam_max_b, lam_max_b, zeros, lam_max_b, v1_b,
            norms)
        beta_b = D.dist_fista_batched(mesh, Xl, Yq, 0.3 * lam_max_b, zeros, L,
                                      iters=FISTA_ITERS)
        torch.cuda.synchronize()
        batch_launches = ops.launch_counts()
        band = flips = 0
        rel = 0.0
        for b in range(B):
            lm = float(lam_max_b[b])
            scores_1, mask_1 = D.dist_edpp_screen_cached(
                mesh, Xl, Yq[b], 0.5 * lm, lm, zero, lm, v1_b[b], norms)
            near = (scores_1 - (1.0 - 1e-6)).abs() < 1e-4
            band += int(near.sum())
            flips += int((mask_1 != mask_b[b]).sum())
            assert not bool(((mask_1 != mask_b[b]) & ~near).any()), b
            beta_1 = D.dist_fista(mesh, Xl, Yq[b], 0.3 * lm, zero, L,
                                  iters=FISTA_ITERS)
            rel = max(rel, float((beta_1 - beta_b[b]).abs().max())
                      / max(float(beta_1.abs().max()), 1e-30))
        print(f"batched B={B}: dist_edpp_screen_batched vs {B} single "
              f"screens: {flips} mask flips, all within the 1e-4 band "
              f"({band} columns in it); dist_fista_batched vs {B} single "
              f"runs: max relative {rel:.3g} (limit {FISTA_REL_TOL:g}); "
              f"launches {batch_launches}")
        assert rel <= FISTA_REL_TOL
        assert batch_launches["fista_step"] == FISTA_ITERS
        assert not any(ops.plain_counts().values()), ops.plain_counts()

        # the (B, n) batch through the mesh session and the unsharded one
        res_b, walls_b = {}, {}
        for arm, s_ in (("unsharded", plain), ("mesh", mesh_sess)):
            s_.reset_solver_cache()
            ops.reset_counts()
            t0 = time.perf_counter()
            res_b[arm] = s_.path(np.stack(Y), **grid)
            torch.cuda.synchronize()
            walls_b[arm] = time.perf_counter() - t0
            counted(ops, ("screen_matvec", "fista_step"))
        r_u, r_m = res_b["unsharded"], res_b["mesh"]
        scale = float(np.abs(r_u.betas).max())
        d_beta = float(np.abs(r_m.betas - r_u.betas).max())
        same = [(a.x_passes, a.n_discarded) == (b.x_passes, b.n_discarded)
                for a, b in zip(r_m.stats, r_u.stats)]
        print(f"mesh session, (B={B}, n) batch, 100 λ: walls "
              + ", ".join(f"{k} {v:.2f} s" for k, v in walls_b.items())
              + f"; masks equal {np.array_equal(r_m.masks, r_u.masks)}; "
              f"max|dbeta| {d_beta:.3g} (limit {1e-6 * scale:.3g}); x_passes"
              f" and n_discarded equal at {sum(same)} of {len(same)} steps; "
              f"betas {r_m.betas.shape}")
        assert r_m.betas.shape == (B, 100, X.shape[1])
        assert np.array_equal(r_m.masks, r_u.masks) and all(same)
        assert d_beta <= 1e-6 * scale
    return launches


def batch_entry(op: str, rows: dict, batched: dict) -> dict:
    """The batched path's reading of a kernel for the summary line: its
    launches in the counted batched run (FISTA; CD for the Gram sweep)
    and, for the three kernels the batch runs at its own shapes, the
    B = BATCH row's times and bound."""
    key = {"screen_matvec": ("screen_matvec", *MNIST, BATCH),
           "fista_step": "batch_fista", "cd_gram_sweep": "batch_cd"}.get(op)
    if key is None:
        return {}
    r = rows[key]
    src = batched["cd_launches" if op == "cd_gram_sweep" else "launches"]
    return {"batched": {
        "B": BATCH, "launches": src[op],
        "shape": [r["n"], r["p"]] if "n" in r else [r["p"], r["p"]],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r.get("matmul_ms")}}


BATCH = 8          # the batched phase's queries: one launch (MAX_B)
BATCH_WIDE = 12    # the screen past MAX_B: two launches
BAND = 1e-4        # score units around 1 − eps where a mask may flip


def path_scores(torch, X64, y, lambdas, betas):
    """Per step, the float64 EDPP scores |x_jᵀc| + ρ‖x_j‖ a path's screen
    tested, from that path's own previous solution, on the card (None at
    λ ≥ λ_max): what a mask flip is held to."""
    yd = torch.as_tensor(y, dtype=torch.float64, device="cuda")
    norms = torch.linalg.vector_norm(X64, dim=0)
    corr = X64.T @ yd
    i = int(torch.argmax(corr.abs()))
    lmax = float(corr[i].abs())
    theta, v1 = yd / lmax, torch.sign(corr[i]) * X64[:, i]
    out = []
    for lam, beta in zip(lambdas, betas):
        if lam >= lmax:
            out.append(None)
            continue
        v2 = yd / lam - theta
        vp = v2 - (v1 @ v2) / (v1 @ v1) * v1
        out.append((X64.T @ (theta + 0.5 * vp)).abs()
                   + 0.5 * torch.linalg.vector_norm(vp) * norms)
        b = torch.as_tensor(beta, dtype=torch.float64, device="cuda")
        theta = (yd - X64 @ b) / lam
        v1 = yd / lam - theta
    return out


def band_flips(torch, X64, y, res_one, mask_b) -> tuple[int, int, float]:
    """(flips, columns in the band, the largest |score − threshold| of a
    flipped column) of a batched query's masks against its single run;
    raises if a flip lies outside the band of the scores the single run
    tested."""
    flips = band = 0
    worst = 0.0
    scores = path_scores(torch, X64, y, res_one.lambdas[0], res_one.betas[0])
    for k, sc in enumerate(scores):
        diff = mask_b[k] != res_one.masks[0, k]
        if sc is None:
            assert not diff.any(), k
            continue
        near = ((sc - (1.0 - 1e-6)).abs() < BAND).cpu().numpy()
        band += int(near.sum())
        flips += int(diff.sum())
        assert not (diff & ~near).any(), f"step {k}: a flip outside the band"
        if diff.any():
            worst = max(worst, float((sc - (1.0 - 1e-6)).abs().cpu()
                                     .numpy()[diff].max()))
    return flips, band, worst


def split(res, what: str) -> float:
    """A path's seconds in its screens or its solves (``PathStepStats``'
    ``screen_time_s`` / ``solve_time_s``, the host clock)."""
    return sum(getattr(s, f"{what}_time_s") for s in res.stats)


def batched_phase(torch) -> dict:
    """The batched multi-query path at full width (see the module doc):
    FISTA and CD arms of one (BATCH, n) batch against single runs, and one
    screen past MAX_B. Returns the launches of the counted batched FISTA
    run, the CD arm's, and the union buckets the kernel rows are timed
    at."""
    from repro_torch import LassoSession, PathConfig, SolveSpec
    from repro_torch.core import ScreeningEngine
    from repro_torch.core import screening as scr
    from repro_torch.data import QueryStream
    from repro_torch.kernels import ops
    stream = QueryStream(n=MNIST[0], p=MNIST[1], batch=BATCH, nnz=16,
                         sigma=0.05, seed=0)
    X = stream.dictionary(np.float32)
    Y = stream.host_batch(0)["y"].astype(np.float32)
    cfg = PathConfig(solve=SolveSpec(tol=1e-6))
    grid = dict(num_lambdas=100, hi_frac=0.95)
    ops.reset_counts()
    t0 = time.perf_counter()
    sess = LassoSession.fit(X)
    res = sess.path(Y, **grid, config=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counted(ops, ("edpp_screen_scores", "screen_matvec",
                             "fista_step"))
    live = [s for s in res.stats if s.screen_backend]
    assert res.betas.shape == (BATCH, 100, MNIST[1]), res.betas.shape
    assert np.isfinite(res.betas).all()
    assert launches["screen_matvec"] <= len(live) + 1, launches
    assert all(s.x_passes == 1 and s.batch_size == BATCH for s in live)
    buckets = [s.bucket for s in live]
    print(f"batched path (B={BATCH}, 100 λ, tol 1e-6) wall {wall:.2f} s; "
          f"{len(live)} live steps; screen_matvec launches "
          f"{launches['screen_matvec']} (limit {len(live) + 1}); fista_step "
          f"{launches['fista_step']}; batched iterations "
          f"{sum(s.solver_iters for s in live)}; query_converged "
          f"{res.query_converged.tolist()}")
    print("union bucket per decile of the grid: " + " ".join(
        f"{np.mean(buckets[k:k + 10]):.0f}" for k in range(0, len(buckets),
                                                          10))
          + f"; median {int(np.median(buckets))}")

    X64 = torch.as_tensor(X, dtype=torch.float64, device="cuda")
    walls, singles, conv1 = [], {}, []
    ops.reset_counts()
    for b in range(BATCH):
        sess.reset_solver_cache()
        t0 = time.perf_counter()
        singles[b] = sess.path(Y[b], res.lambdas[b], config=cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        conv1.append(bool(singles[b].query_converged[0]))
    single_launches = counted(ops, ("screen_matvec", "fista_step"))
    flips = band = 0
    for b in range(BATCH):
        f, n_band, _ = band_flips(torch, X64, Y[b], singles[b], res.masks[b])
        flips, band = flips + f, band + n_band
        err = float(np.abs(res.betas[b] - singles[b].betas[0]).max())
        assert err <= beta_err_tol(Y[b], 1e-6), (b, err)
    print(f"against {BATCH} single runs: {flips} mask flips, all in the "
          f"±{BAND:g} band ({band} step-columns in it); beta within "
          f"beta_err_tol per query; single query_converged {conv1}; walls: "
          f"batched {wall:.2f} s, the {BATCH} single runs {sum(walls):.2f} s "
          f"({' '.join(f'{w:.2f}' for w in walls)}); screen_matvec launches "
          f"batched {launches['screen_matvec']}, singles "
          f"{single_launches['screen_matvec']}; fista_step batched "
          f"{launches['fista_step']}, singles {single_launches['fista_step']}")
    print("host-clock split, batched / the 8 single runs: "
          + "; ".join(f"{what} {split(res, what):.3f} / "
                      f"{sum(split(r, what) for r in singles.values()):.3f}"
                      f" s" for what in ("screen", "solve")))
    del singles, X64

    cd_cfg = PathConfig(solve=SolveSpec(strategy="cd", tol=1e-6))
    sess.reset_solver_cache()
    ops.reset_counts()
    t0 = time.perf_counter()
    res_cd = sess.path(Y, res.lambdas, config=cd_cfg)
    torch.cuda.synchronize()
    cd_wall = time.perf_counter() - t0
    cd_launches = counted(ops, ("screen_matvec", "cd_gram_sweep"))
    live_cd = [s for s in res_cd.stats if s.screen_backend]
    max_epochs = cd_cfg.solve.max_iter // 10 + 1
    gram = [s.gram_step_frac == 1.0 for s in live_cd]
    at_max = sum(s.solver_iters >= max_epochs for s in live_cd)
    errs = [float(np.abs(res_cd.betas[b] - res.betas[b]).max())
            for b in range(BATCH)]
    limits = [min(beta_err_tol(Y[b], 1e-6),
                  CD_REL_TOL * float(np.abs(res.betas[b]).max()))
              for b in range(BATCH)]
    cd_buckets = [s.bucket for s in live_cd]
    print(f"CD arm (B={BATCH}, tol 1e-6) wall {cd_wall:.2f} s; {sum(gram)} "
          f"of {len(live_cd)} steps on cd_gram_sweep at B={BATCH} with "
          f"valid; steps at max_epochs {at_max}; query_converged "
          f"{res_cd.query_converged.tolist()}; cd_gram_sweep launches "
          f"{cd_launches['cd_gram_sweep']}; max|beta_cd - beta_fista| per "
          f"query {[f'{e:.3g}' for e in errs]} (limits "
          f"{[f'{x:.3g}' for x in limits]})")
    assert all(gram) and at_max == 0 and res_cd.query_converged.all()
    assert all(e <= x for e, x in zip(errs, limits))
    del res_cd

    wide = QueryStream(n=MNIST[0], p=MNIST[1], batch=BATCH_WIDE, nnz=16,
                       sigma=0.05, seed=0)
    Yw = torch.as_tensor(wide.host_batch(0)["y"].astype(np.float32),
                         device="cuda")
    geom = sess.geometry
    eng = ScreeningEngine(sess.X, Yw, geometry=geom)
    st = eng.state_at_lambda_max()
    lam = 0.5 * np.asarray(eng.lam_max)
    ops.reset_counts()
    mask_w = eng.screen(lam, st, "edpp")
    torch.cuda.synchronize()
    wide_launches = ops.launch_counts()["screen_matvec"]
    centres = torch.stack([scr.make_sphere("edpp", Yw[b].clone(),
                                           float(lam[b]), st.query(b)).centre
                           for b in range(BATCH_WIDE)])
    dots = geom.backend.matvec(sess.X, centres)
    same = 0
    for b in range(BATCH_WIDE):
        one = ScreeningEngine(sess.X, Yw[b].clone(), geometry=geom)
        st1 = one.state_at_lambda_max()
        same += int(torch.equal(mask_w[b], one.screen(float(lam[b]), st1,
                                                      "edpp"))
                    and torch.equal(dots[b], geom.backend.matvec(
                        sess.X, scr.make_sphere("edpp", one.ws.y,
                                                float(lam[b]),
                                                st1).centre)))
    print(f"screen past MAX_B: B={BATCH_WIDE} in {wide_launches} "
          f"screen_matvec launches; masks and dots bit for bit the single "
          f"screens for {same} of {BATCH_WIDE} queries")
    assert wide_launches == 2 and same == BATCH_WIDE
    return {"launches": launches, "cd_launches": cd_launches,
            "bucket": int(np.median(buckets)),
            "cd_bucket": int(np.median(cd_buckets))}


SERVE_QUERIES = 44      # five fill batches of 8, then a 4-query tail
SERVE_ARGV = ["--n", str(MNIST[0]), "--p", str(MNIST[1]), "--nnz", "16",
              "--seed", "0", "--b-max", str(BATCH), "--deadline-ms", "20",
              "--queue-cap", "64", "--max-in-flight", "2", "--num-queries",
              str(SERVE_QUERIES), "--num-lambdas", "16", "--hi-frac", "0.95",
              "--lo-frac", "0.1", "--solver-tol", "1e-6"]


def tail_reason(report) -> str:
    """The reason the loop must give the last, partial batch: "deadline"
    when its oldest query had waited the policy's deadline at dispatch
    (checked first), else "drain" (the source is exhausted)."""
    last = report.trace[-1]
    waited = last.t - min(t.t_admit for t in report.tickets
                          if t.batch_id == last.batch_id)
    return "deadline" if waited >= report.policy.deadline_s else "drain"


def serve_readings(report) -> str:
    s = report.summary()
    return (f"served {s['n_ok']}/{s['n_queries']} in {s['wall_time_s']:.3f} "
            f"s: {s['queries_per_sec']:.2f} queries/sec, latency p50 "
            f"{s['p50_latency_s'] * 1e3:.1f} ms p99 "
            f"{s['p99_latency_s'] * 1e3:.1f} ms, errors {s['n_errors']}, "
            f"unconverged {s['n_unconverged']}, trace "
            + " ".join(f"{r.reason}:{r.n_live}/{r.padded_b}"
                       for r in report.trace))


def serve_phase(torch, tmp: str) -> dict:
    """``repro_torch.launch.serve.main`` in-process at the batched path's
    width: compare mode (both arms served whole, every mask bit for bit the
    direct call, the traces the policy gives), then a continuous ``--solver
    cd`` run, every live step on ``cd_gram_sweep``. Returns the launches of
    each run."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    bench = os.path.join(tmp, "serve.json")
    ops.reset_counts()
    t0 = time.perf_counter()
    out = serve.main([*SERVE_ARGV, "--mode", "compare", "--repeats",
                      "1", "--check-masks", "0", "--bench-json", bench])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counted(ops, ("edpp_screen_scores", "screen_matvec",
                             "fista_step"))
    reps = out["reports"]
    for mode, rep in reps.items():
        print(f"  {mode}: {serve_readings(rep)}")
    print(f"serve compare wall {wall:.2f} s (fit, 2 warm-up and 2 timed "
          f"arms, {2 * SERVE_QUERIES} direct replays); continuous / fixed "
          f"queries/sec {out['ratio']:.3f}; launches "
          + ", ".join(f"{k} {launches[k]}" for k in ops.OPS))
    full = [("fill", BATCH, BATCH)] * (SERVE_QUERIES // BATCH)
    tail = SERVE_QUERIES % BATCH
    want = {"fixed": full + [("drain", tail, BATCH)],
            "continuous": full + [(tail_reason(reps["continuous"]), tail,
                                   tail)]}
    for mode, rep in reps.items():
        s = rep.summary()
        assert s["n_ok"] == s["n_queries"] == SERVE_QUERIES, (mode, s)
        assert s["n_errors"] == 0 and all(t.ok for t in rep.tickets)
        assert [(r.reason, r.n_live, r.padded_b)
                for r in rep.trace] == want[mode], (mode, rep.trace)
    assert os.path.exists(bench)
    # a served query's masks against its direct call: bit for bit except
    # for columns within the rounding band of the threshold (the batch's
    # solve runs on the union bucket, the single one on its own)
    sess = out["session"]
    X64 = sess.X.to(torch.float64)
    flips = band = 0
    worst = 0.0
    for mode, qids in out["mismatched"].items():
        for t in reps[mode].tickets:
            if t.qid in qids:
                f, n_band, w = band_flips(torch, X64, t.y, sess.path(
                    t.y, t.result.lambdas), t.result.masks)
                flips, band, worst = flips + f, band + n_band, max(worst, w)
    print(f"served masks against the direct calls: queries not bit for bit "
          f"{out['mismatched']}; {flips} mask flips, all in the ±{BAND:g} "
          f"band ({band} step-columns of those queries in it), the "
          f"farthest {worst:.3g} from the threshold")
    del X64, sess, out

    ops.reset_counts()
    t0 = time.perf_counter()
    cd = serve.main([*SERVE_ARGV, "--solver", "cd", "--mode",
                     "continuous"])["reports"]["continuous"]
    torch.cuda.synchronize()
    cd_wall = time.perf_counter() - t0
    cd_launches = counted(ops, ("edpp_screen_scores", "screen_matvec",
                                "cd_gram_sweep"))
    steps = {id(st): st for t in cd.tickets for st in t.result.stats
             if st.screen_backend}.values()
    # the Gram crossover: a bucket of at most min(n, GRAM_BUCKET_MAX)
    # columns runs on cd_gram_sweep, a wider one on matvec CD (plain torch
    # in both packages)
    limit = min(MNIST[0], ops.GRAM_BUCKET_MAX)
    gram = [st for st in steps if st.bucket <= limit]
    wide = sorted(st.bucket for st in steps if st.bucket > limit)
    print(f"  cd: {serve_readings(cd)}")
    print(f"serve --solver cd wall {cd_wall:.2f} s (fit, a warm-up and a "
          f"timed run); {len(gram)} of {len(steps)} live batch steps with "
          f"union buckets ≤ {limit} columns, all on cd_gram_sweep; the "
          f"other {len(wide)} (buckets {wide}) on matvec CD; launches "
          f"cd_gram_sweep {cd_launches['cd_gram_sweep']}, fista_step "
          f"{cd_launches['fista_step']}")
    assert cd.summary()["n_errors"] == 0 and all(t.ok for t in cd.tickets)
    assert cd.summary()["n_ok"] == SERVE_QUERIES
    assert gram and all(st.gram_step_frac == 1.0 for st in gram)
    assert all(st.gram_step_frac == 0.0 for st in steps
               if st.bucket > limit)
    assert cd_launches["fista_step"] == 0
    return {"launches": launches, "cd_launches": cd_launches}


def solve_phase(torch, tmp: str) -> dict:
    """``repro_torch.launch.solve.main`` in-process: the plain path at the
    main path's width with checkpoints (the last one holds the result's
    last β), and the group path. Returns the launches of each run."""
    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.kernels import ops
    from repro_torch.launch import solve
    ckpt = os.path.join(tmp, "ckpt")
    ops.reset_counts()
    t0 = time.perf_counter()
    n, p = MNIST
    res = solve.main(["--n", str(n), "--p", str(p), "--nnz", "16",
                      "--no-x64", "--num-lambdas", "20", "--ckpt-dir",
                      ckpt])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counted(ops, ("edpp_screen_scores", "screen_matvec",
                             "fista_step"))
    step = latest_step(ckpt)
    tree, extra = restore(ckpt, step, {"beta": 0}, device="cpu")
    same = np.array_equal(tree["beta"].numpy().astype(np.float64),
                          res.betas[-1])
    live = [s for s in res.stats if s.screen_backend]
    print(f"solve wall {wall:.2f} s ({n} × {p}, 20 λ, tol "
          f"1e-8): {sum(s.solver_iters >= 5000 for s in live)} of "
          f"{len(live)} live steps at max_iter; latest checkpoint step "
          f"{step}, its beta equal to the result's last {same}, its λ "
          f"{extra['lam']:.6g}; launches "
          + ", ".join(f"{k} {launches[k]}" for k in ops.OPS))
    assert step == 19 and same and np.isfinite(res.betas).all()
    assert sorted(os.listdir(ckpt)) == [f"step_{k:08d}" for k in (17, 18,
                                                                    19)]
    n_g, p_g, m = GROUP_EXACT
    ops.reset_counts()
    t0 = time.perf_counter()
    res_g = solve.main(["--n", str(n_g), "--p", str(p_g), "--group-size",
                        str(m), "--nnz", "200", "--no-x64", "--num-lambdas",
                        "20"])
    torch.cuda.synchronize()
    g_wall = time.perf_counter() - t0
    g_launches = counted(ops, ("group_screen_scores",))
    print(f"solve --group-size {m} wall {g_wall:.2f} s ({n_g} × {p_g}, 20 "
          f"λ); launches group_screen_scores "
          f"{g_launches['group_screen_scores']}")
    assert res_g.masks.shape == (20, p_g // m)
    assert np.isfinite(res_g.betas).all()
    return {"launches": launches, "group_launches": g_launches}


def main(argv: list[str]) -> int:
    tree = None
    if len(argv) == 3 and argv[:2] == ["--kernels", "--tree"]:
        tree, argv = os.path.abspath(argv[2]), ["--kernels"]
        sys.path.insert(0, os.path.join(tree, "src"))
    if argv not in ([], ["--faults"], ["--kernels"]):
        print("usage: python3 chip_smoke.py [--faults | --kernels "
              "[--tree DIR]]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
    from repro_torch import kernels
    from repro_torch.data import group_lasso_problem
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
        ptxas = ptxas_table(logs)
        for name, log in logs.items():       # ptxas -v, per library
            t = ptxas_table({name: log})
            regs = sorted({v[0] for v in t.values()})
            spill = sum(v[1] + v[2] for v in t.values())
            print(f"  {name}: {len(t)} kernels, registers {regs}, spill "
                  f"bytes {spill}")

    if argv == ["--faults"]:
        with phase("fault check of the CD, group and dist_fista checks"):
            fault_check(torch)
        return 0

    rows = {}
    with phase("kernels against their plain versions"):
        one = torch.zeros(1, device="cuda")
        floor_ms = event_ms(torch, lambda: one.zero_())
        print(f"  launch floor (1-element zero_(), CUDA events, median of "
              f"{REPS}): {floor_ms:.4f} ms", flush=True)
        cases = [(op, *MNIST, B) for op in ("edpp_screen_scores",
                                            "screen_matvec") for B in (1, 8)]
        cases += [(op, *SVHN, 1) for op in ("edpp_screen_scores",
                                            "screen_matvec")]
        cases += [("fista_step", 784, p, B) for p in (32, 512, 4096)
                  for B in (1, 8)]
        cases += [("fista_step", *MNIST, 1)]          # the unscreened arm
        cases += [(op, 777, 1001, 3) for op in ("edpp_screen_scores",
                                                "screen_matvec", "fista_step")]
        for i, case in enumerate(cases):
            rows[case] = check_kernel(torch, kernels, ref, *case, seed=i,
                                      floor_ms=floor_ms, ptxas=ptxas)
        choices = [cluster_choice(torch, kernels, ref, 784, pp, B,
                                  seed=90 + B) for pp in (32, 512)
                   for B in (1, 8)]
        step_ns = chain_step_ns(torch, kernels)
        print("  cd chain: one dependent coordinate step "
              + ("n/a (no cd_chain_f32 in this tree)" if step_ns is None
                 else f"{step_ns:.2f} ns ({CHAIN_TURNS} turns of 32 steps, "
                      f"one warp, no loads)"), flush=True)
        for i, (bp, B) in enumerate([(b, B) for b in (32, 256, 1024)
                                     for B in (1, 8)]):
            rows[("cd", bp, B)] = check_cd(torch, kernels, ref, bp, B,
                                           seed=100 + i, step_ns=step_ns,
                                           ptxas=ptxas)
        rows[("cd", 256, 8, "valid")] = check_cd(
            torch, kernels, ref, 256, 8, seed=110, masked=True,
            step_ns=step_ns, ptxas=ptxas)
        n_g, p_g, _ = GROUP_FULL
        for i, m in enumerate((5, 10, 20, 200)):
            rows[("group", n_g, p_g, m)] = check_group(
                torch, kernels, ref, n_g, p_g, m, seed=120 + i, ptxas=ptxas)
        for i, (pp, m) in enumerate(((1000, 5), (1001, 7))):
            rows[("group", 777, pp, m)] = check_group(
                torch, kernels, ref, 777, pp, m, seed=130 + i, ptxas=ptxas)
        floors = {"alone": floor_ms,
                  "run": run_ms(torch, lambda: one.zero_(), GRAPH_RUN),
                  "graph": graph_ms(torch, lambda: one.zero_(), GRAPH_RUN)}
        print(f"  launch floor per 1-element zero_() in a run of {GRAPH_RUN} "
              f"from Python {floors['run']:.4f} ms, replayed from a graph of "
              f"{GRAPH_RUN} {floors['graph']:.4f} ms", flush=True)
        for i, (pp, B, per_query) in enumerate([(MNIST[1], 1, False),
                                                (MNIST[1], 8, False),
                                                (1003, 3, True)]):
            rows[("prox", pp, B)] = check_prox(torch, kernels.prox_step, ref,
                                               pp, B, per_query, seed=140 + i,
                                               floors=floors)
        if hasattr(kernels.solver_step, "MAX_PARTS"):   # trees with parts
            for i, (pp, B) in enumerate([(MNIST[1], 1), (MNIST[1], 8),
                                         (1003, 3)]):
                rows[("prox_parts", pp, B)] = check_prox(
                    torch, kernels.prox_step, ref, pp, B, True, seed=150 + i,
                    floors=floors, parts=PARTS)
        floor_end = event_ms(torch, lambda: one.zero_())
        print(f"  launch floor again: {floor_end:.4f} ms", flush=True)

    if argv == ["--kernels"]:
        print(json.dumps({"tree": tree or HERE, "launch_floor_ms":
                          [floor_ms, floor_end], "floors": floors,
                          "cluster": choices,
                          "rows": [dict(r, key=str(k))
                                   for k, r in rows.items()]}))
        print(smi)
        return 0

    X, y = make_dataset(*MNIST)
    n, p = MNIST
    with phase("main path: fit + 100-λ path, default config"):
        ops.reset_counts()
        t0 = time.perf_counter()
        sess = LassoSession.fit(X)
        res = sess.path(y, num_lambdas=100)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counted(ops, ("edpp_screen_scores", "screen_matvec",
                                 "fista_step"))
        assert sess.geometry.X.is_cuda and sess.backend_name == "cuda"
        assert sess.fit_passes == 1, sess.fit_passes
        live = [s for s in res.stats if s.screen_backend]   # λ < λ_max
        assert live and all(s.x_passes == 1 for s in live)
        assert np.isfinite(res.betas).all()
        cfg = sess.config.solve
        at_max = sum(s.solver_iters >= cfg.max_iter for s in live)
        iters = sum(s.solver_iters for s in res.stats)
        print(f"path wall {wall:.2f} s; {len(live)} live steps, all at "
              f"x_passes=1; fit_passes={sess.fit_passes}; steps at "
              f"max_iter={cfg.max_iter} (tol {cfg.tol:g}): {at_max}; "
              f"solver iterations {iters}; query_converged "
              f"{bool(res.query_converged[0])}")
        print("discard fraction per decile of the grid: "
              + deciles(res, p))
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

    with phase("CD path: fit + 100-λ EDPP path, strategy='cd', tol 1e-6"):
        cd_cfg = PathConfig(solve=SolveSpec(strategy="cd", tol=1e-6))
        ops.reset_counts()
        t0 = time.perf_counter()
        cd_sess = LassoSession.fit(X, config=cd_cfg)
        res_cd = cd_sess.path(y, num_lambdas=100)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cd_launches = counted(ops, ("edpp_screen_scores", "screen_matvec",
                                    "cd_gram_sweep"))
        live = [s for s in res_cd.stats if s.screen_backend]
        max_epochs = cd_cfg.solve.max_iter // 10 + 1
        at_max = sum(s.solver_iters >= max_epochs for s in live)
        gram = sum(s.gram_step_frac == 1.0 for s in live)
        by_bucket = {}
        for s in live:
            by_bucket[s.bucket] = by_bucket.get(s.bucket, 0) + s.solver_iters
        cd_bucket = max(by_bucket, key=by_bucket.get)
        print(f"CD path wall {wall:.2f} s; {len(live)} live steps, {gram} "
              f"on the Gram system; steps at max_epochs={max_epochs}: "
              f"{at_max}; sweeps per bucket {dict(sorted(by_bucket.items()))}"
              f"; query_converged {bool(res_cd.query_converged[0])}")
        print("discard fraction per decile of the grid: "
              + deciles(res_cd, p))
        assert np.isfinite(res_cd.betas).all() and gram > 0
        t0 = time.perf_counter()
        res_fi = cd_sess.path(y, num_lambdas=100, config=PathConfig(
            solve=SolveSpec(tol=1e-6)))
        r = cd_readings(res_cd, res_fi, max_epochs)
        fails = cd_failures(r, y)
        print(f"FISTA EDPP path at tol 1e-6: {time.perf_counter() - t0:.2f} "
              f"s; max|beta_cd - beta_fista| = {r['err']:.3g} (limits "
              f"{beta_err_tol(y, 1e-6):.3g} and {CD_REL_TOL:g}·max|beta_"
              f"fista| = {CD_REL_TOL * r['scale']:.3g}); failures {fails}")
        assert not fails, fails

    with phase("distributed: NCCL world of 1, (1, 1) mesh, 784 × 50 000"):
        dist_launches = distributed_phase(torch, X, y)

    del X, y, res, res_cd, res_fi
    with phase(f"batched path: QueryStream B={BATCH}, 784 × 50 000, 100 λ, "
               f"FISTA and CD, tol 1e-6"):
        batched = batched_phase(torch)

    del sess, cd_sess
    n_g, p_g, m = GROUP_FULL
    X, y, _ = group_lasso_problem(n_g, p_g, m, active_groups=200, seed=0,
                                  dtype=np.float32)
    units = p_g // m
    with phase(f"group path: fit(groups={m}) + 100-λ group EDPP, tol 1e-6, "
               f"{n_g} × {p_g}"):
        g_cfg = PathConfig(solve=SolveSpec(tol=1e-6))
        ops.reset_counts()
        t0 = time.perf_counter()
        g_sess = LassoSession.fit(X, groups=m, config=g_cfg)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        res_g = g_sess.path(y, num_lambdas=100)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        group_launches = counted(ops, ("group_screen_scores",))
        live = [s for s in res_g.stats if s.screen_backend]
        at_max = sum(s.solver_iters >= g_cfg.solve.max_iter for s in live)
        buckets = sorted({s.bucket // m for s in live})
        print(f"group path wall {wall:.2f} s (fit, spectral norms of "
              f"{units} groups: {fit_s:.2f} s); {len(live)} live steps; "
              f"steps at max_iter={g_cfg.solve.max_iter}: {at_max}; "
              f"solver iterations {sum(s.solver_iters for s in live)}; "
              f"buckets (groups) {buckets}; query_converged "
              f"{bool(res_g.query_converged[0])}")
        print("group discard fraction per decile of the grid: "
              + deciles(res_g, units))
        assert np.isfinite(res_g.betas).all()
        assert g_sess.fit_passes == 1 and g_sess.backend_name == "cuda"
        assert all(s.x_passes == 1 for s in live)
    del g_sess, res_g

    n_e, p_e, m = GROUP_EXACT
    X, y, _ = group_lasso_problem(n_e, p_e, m, active_groups=20, seed=0,
                                  dtype=np.float32)
    with phase(f"group exactness: EDPP and strong vs unscreened, tol 1e-6, "
               f"20 λ, {n_e} × {p_e}, m = {m}"):
        e_sess = LassoSession.fit(X, groups=m)
        arms = {}
        for rule in ("none", "edpp", "strong"):
            e_sess.reset_solver_cache()
            ops.reset_counts()
            t0 = time.perf_counter()
            # the screened arms solve on the unscreened arm's grid
            grid = arms["none"].lambdas[0] if arms else None
            arms[rule] = e_sess.path(y, grid, num_lambdas=20, hi_frac=0.95,
                                     config=PathConfig(
                                         screen=ScreenSpec(rule=rule),
                                         solve=SolveSpec(tol=1e-6)))
            counted(ops, () if rule == "none" else ("group_screen_scores",))
            st = arms[rule].stats
            print(f"  {rule}: {time.perf_counter() - t0:.2f} s, converged "
                  f"{bool(arms[rule].query_converged[0])}, steps at max_iter "
                  f"{sum(s.solver_iters >= 5000 for s in st)}, kkt rounds "
                  f"{sum(s.kkt_rounds for s in st)}")
        for rule in ("edpp", "strong"):
            r = group_readings(arms[rule], arms["none"], m)
            fails = group_failures(r, y)
            print(f"group {rule}: max|beta - beta_none| = {r['err']:.3g} "
                  f"(limits {beta_err_tol(y, 1e-6):.3g} and "
                  f"{GROUP_REL_TOL:g}·max|beta_none| = "
                  f"{GROUP_REL_TOL * r['scale']:.3g}); unsafe group discards "
                  f"{r['unsafe']}; mean discard fraction {r['discard']:.4f}; "
                  f"failures {fails}")
            assert not fails, fails
        # a (2, n) group batch against its two single runs, in the same
        # order from the same cold eigenvector cache: the same bits
        rng = np.random.default_rng(1)
        w = np.zeros(p_e)
        for g in rng.choice(p_e // m, 20, replace=False):
            w[g * m:(g + 1) * m] = rng.uniform(-1.0, 1.0, m)
        Y2 = np.stack([y, (X @ w + 0.1 * rng.standard_normal(n_e))
                       .astype(np.float32)])
        g_cfg = PathConfig(solve=SolveSpec(tol=1e-6))
        e_sess.reset_solver_cache()
        ops.reset_counts()
        res2 = e_sess.path(Y2, num_lambdas=20, hi_frac=0.95, config=g_cfg)
        counted(ops, ("group_screen_scores",))
        e_sess.reset_solver_cache()
        ones = [e_sess.path(Y2[b], res2.lambdas[b], config=g_cfg)
                for b in range(2)]
        equal = [np.array_equal(res2.masks[b], ones[b].masks[0])
                 and np.array_equal(res2.betas[b], ones[b].betas[0])
                 for b in range(2)]
        print(f"group batch (2, {n_e}): masks and betas bit for bit its two "
              f"single runs {equal}; query_converged "
              f"{res2.query_converged.tolist()}; batch_size "
              f"{res2.stats[-1].batch_size}")
        assert all(equal) and res2.betas.shape == (2, 20, p_e)
        assert all(s.batch_size == 2 for s in res2.stats)

    with tempfile.TemporaryDirectory() as tmp:
        with phase(f"serve: repro_torch.launch.serve.main, compare then "
                   f"--solver cd, {SERVE_QUERIES} queries, {n} × {p}, "
                   f"B_max {BATCH}, 16 λ"):
            served = serve_phase(torch, tmp)
        with phase(f"solve: repro_torch.launch.solve.main, {n} × {p} with "
                   f"checkpoints and {n_e} × {p_e} groups of {m}, 20 λ"):
            solved = solve_phase(torch, tmp)

    with phase(f"kernels at the paths' shapes (fista bucket {main_bucket}, "
               f"cd bucket {cd_bucket}; batched B={BATCH}: fista bucket "
               f"{batched['bucket']}, cd bucket {batched['cd_bucket']})"):
        rows["main_fista"] = check_kernel(torch, kernels, ref, "fista_step",
                                          n, main_bucket, 1, seed=99,
                                          floor_ms=floor_ms, ptxas=ptxas)
        rows["main_cd"] = check_cd(torch, kernels, ref, cd_bucket, 1,
                                   seed=98, step_ns=step_ns, ptxas=ptxas)
        rows["batch_fista"] = check_kernel(
            torch, kernels, ref, "fista_step", n, batched["bucket"], BATCH,
            seed=97, floor_ms=floor_ms, ptxas=ptxas, block=True)
        rows["batch_cd"] = check_cd(torch, kernels, ref,
                                    batched["cd_bucket"], BATCH, seed=96,
                                    masked=True, step_ns=step_ns, ptxas=ptxas)
    main_launches.update(cd_gram_sweep=cd_launches["cd_gram_sweep"],
                         group_screen_scores=group_launches[
                             "group_screen_scores"],
                         prox_step=dist_launches["prox_step"])
    summary = []
    for op, key in (("edpp_screen_scores", ("edpp_screen_scores", *MNIST, 1)),
                    ("screen_matvec", ("screen_matvec", *MNIST, 1)),
                    ("fista_step", "main_fista"),
                    ("cd_gram_sweep", "main_cd"),
                    ("group_screen_scores", ("group", *GROUP_FULL)),
                    ("prox_step", ("prox_parts", MNIST[1], 1))):
        r = rows[key]
        summary.append({
            "name": op, "route": "cuda", "source": SOURCES[op],
            "replaces": REPLACES[op], "launches": main_launches[op],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # torch.matmul(c, X) computes screen_matvec's function exactly;
            # torch.sum(parts, 0) the prox step's sum of its parts (not the
            # prox); the other four have no single library call
            "library_ms": (r["matmul_ms"] if op == "screen_matvec" else
                           r.get("library_ms")),
            **({"chain_bound_ms": r["chain_ms"]}
               if op == "cd_gram_sweep" else {}),
            **({"graph_ms": r["graph_ms"], "run_ms": r["run_ms"],
                "parts": r["parts"]} if op == "prox_step" else {}),
            **batch_entry(op, rows, batched),
            # the serve phase's compare run (fit, four arms, the direct
            # replays) and, for cd_gram_sweep, its --solver cd run
            "serve_launches": served["launches"][op],
            **({"serve_cd_launches": served["cd_launches"][op]}
               if op == "cd_gram_sweep" else {}),
            "solve_launches": (solved["group_launches"] if op ==
                               "group_screen_scores" else
                               solved["launches"])[op]})
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
