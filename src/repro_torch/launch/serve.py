"""Lasso query serving CLI: a thin driver over the continuous-batching
control plane in :mod:`repro_torch.launch.serve_loop`, the reference's
``src/repro/launch/serve.py`` on the port's sessions.

One fitted dictionary (a :class:`repro_torch.LassoSession` on the card),
a deterministic query stream (:class:`repro_torch.data.QueryStream`,
keyed by (seed, step, shard)), and a batch-formation policy:

  * ``--mode continuous`` (default): the real server: bounded admission
    queue, dispatch at fill target ``--b-max`` OR when the oldest query
    has waited ``--deadline-ms``, pow-2-padded partial batches, pipelined
    dispatch up to ``--max-in-flight``.
  * ``--mode fixed``: the fixed micro-batch server: the same loop pinned
    to always-pad-to-B (``pad="full"``) with no deadline.
  * ``--mode compare`` (what ``--quick`` selects): BOTH arms on identical
    replayed streams, per-query screening masks re-checked bit for bit
    against direct ``session.path`` calls, and, with ``--bench-json
    PATH``, a ``bench_serve`` section merged into PATH (p50/p99
    admission→completion latency, queries/sec, batch-fill and
    dispatch-reason telemetry). Without ``--bench-json`` no file is
    written.

It runs on the card unless ``--device cpu`` is given, in float32
(``--x64``, float64 arrays, runs on the CPU only). The λ grids stop at
``--hi-frac`` (default 0.95) of each query's λ_max, inside the bitwise
exactness contract: a served mask equals the direct call's, except that a
column within float32 rounding of its threshold may flip, because a
batch's solve (on the union bucket) and a single query's round
differently.

    PYTHONPATH=src python -m repro_torch.launch.serve --n 150 --p 1000 \\
        --b-max 8 --deadline-ms 10 --num-queries 200 --num-lambdas 16
    PYTHONPATH=src python -m repro_torch.launch.serve --quick --device cpu
"""

from __future__ import annotations

import argparse
import fnmatch
import math
import os
import time

import numpy as np
import torch

from ..core import LassoSession
from ..data import QueryStream
from . import cli
from . import serve_loop as sl


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    cli.add_problem_args(ap, n=150, p=1000, nnz=20)
    cli.add_engine_args(ap)
    cli.add_mesh_arg(ap)
    cli.add_serve_args(ap)
    cli.add_x64_arg(ap, default=False)
    cli.add_device_arg(ap)
    ap.add_argument("--num-queries", type=int, default=128)
    ap.add_argument("--num-lambdas", type=int, default=16,
                    help="per-query λ-grid points (each query gets the "
                         "paper grid over its own λ_max)")
    ap.add_argument("--lo-frac", type=float, default=0.1)
    ap.add_argument("--hi-frac", type=float, default=0.95,
                    help="grid start as a fraction of λ_max; < 1 keeps "
                         "every grid point inside the bitwise exactness "
                         "contract")
    ap.add_argument("--solver-tol", type=float, default=1e-6)
    ap.add_argument("--check-masks", type=int, default=12,
                    help="in compare mode, replay this many served "
                         "queries through a direct session.path call and "
                         "require bit-identical masks (0 = all)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="compare mode times each arm this many times and "
                         "scores the best run")
    ap.add_argument("--quick", action="store_true",
                    help="smoke: small shapes, compare mode, bench "
                         "assertions on")
    ap.add_argument("--bench-json", default=None,
                    help="where compare mode merges its bench_serve "
                         "section (default: no file)")
    ap.add_argument("--report-every", type=int, default=0,
                    help="print a progress line every k completions")
    args = ap.parse_args(argv)
    if args.bench_json is not None and fnmatch.fnmatch(
            os.path.basename(args.bench_json), "BENCH_*.json"):
        raise SystemExit(f"--bench-json {args.bench_json}: BENCH_*.json "
                         f"files are the reference's; name another file")
    return args


def _policy(args, mode: str):
    fixed = mode == "fixed"
    return sl.ServePolicy(
        b_max=args.b_max,
        deadline_s=math.inf if fixed else args.deadline_ms / 1e3,
        queue_cap=max(args.queue_cap, args.b_max),
        max_in_flight=args.max_in_flight,
        pad="full" if fixed else "pow2")


def _run_arm(args, sess, stream, mode: str, dtype, *, progress=False):
    """One timed serve run: a fresh arrival script (identical replay: the
    stream is (seed, step, shard)-keyed) through a fresh loop."""
    executor = sl.SessionExecutor(sess, num_lambdas=args.num_lambdas,
                                  lo_frac=args.lo_frac,
                                  hi_frac=args.hi_frac)
    arrivals = sl.stream_arrivals(stream, args.num_queries,
                                  rate=args.arrival_rate, dtype=dtype)
    done = [0]

    def on_complete(t):
        done[0] += 1
        if progress and args.report_every \
                and done[0] % args.report_every == 0 \
                and cli.is_main_process():
            print(f"  [{mode}] {done[0]:5d}/{args.num_queries} served")

    loop = sl.ServeLoop(arrivals, executor, policy=_policy(args, mode),
                        on_complete=on_complete)
    return loop.run()


def _print_report(mode: str, report) -> None:
    s = report.summary()
    shapes = sorted({r.padded_b for r in report.trace})
    print(f"[{mode:10s}] served {s['n_ok']}/{s['n_queries']} queries in "
          f"{s['wall_time_s']:.3f}s  ({s['queries_per_sec']:.2f} "
          f"queries/sec)")
    print(f"             latency p50 {s['p50_latency_s'] * 1e3:.1f}ms  "
          f"p99 {s['p99_latency_s'] * 1e3:.1f}ms  "
          f"batch fill {s['mean_batch_fill']:.2f}  "
          f"dispatches {s['dispatch_reasons']}")
    print(f"             padded batch shapes {shapes} "
          f"(O(log B) batch shapes)  errors {s['n_errors']}  "
          f"unconverged {s['n_unconverged']}")


def _mask_mismatches(sess, report, check: int) -> list:
    """Replay served queries (the first ``check``; 0 = all) through a
    direct ``session.path`` call on the grid the serve answer used; the
    qids whose masks are not bit-identical to it."""
    sample = report.ok_tickets if check <= 0 else report.ok_tickets[:check]
    return [t.qid for t in sample if not np.array_equal(
        sess.path(t.y, t.result.lambdas).masks[0], t.result.masks)]


def _bench_row(args, mode: str, report, masks_ok: bool) -> dict:
    s = report.summary()
    return {
        "dataset": f"synthetic n={args.n} p={args.p}",
        "rule": args.rule,
        "solver": args.solver,
        "backend": args.backend or "auto",
        "mode": mode,
        "b_max": args.b_max,
        "deadline_ms": None if mode == "fixed" else args.deadline_ms,
        "queue_cap": args.queue_cap,
        "arrival_rate": args.arrival_rate,
        "num_queries": s["n_queries"],
        "num_lambdas": args.num_lambdas,
        "queries_per_sec": s["queries_per_sec"],
        "p50_latency_s": s["p50_latency_s"],
        "p99_latency_s": s["p99_latency_s"],
        "wall_time_s": s["wall_time_s"],
        "n_dispatches": s["n_dispatches"],
        "mean_batch_fill": s["mean_batch_fill"],
        "deadline_dispatch_frac": s["deadline_dispatch_frac"],
        "backpressure_waits": s["backpressure_waits"],
        "n_errors": s["n_errors"],
        "n_unconverged": s["n_unconverged"],
        "masks_identical": bool(masks_ok),
    }


def main(argv=None) -> dict:
    """Run the server. Returns ``{"reports": {mode: ServeReport},
    "session": LassoSession}``, in compare mode with ``"mismatched"``
    ({mode: qids whose served masks differ from the direct call}),
    ``"masks_identical"`` ({mode: bool}) and ``"ratio"`` (continuous over
    fixed queries/sec) beside them."""
    args = _parse_args(argv)
    device = cli.setup_device(args)
    if args.quick:
        # small shapes; 40 queries at B_max=16 leave a partial tail
        # (16+16+8), which is where continuous batching's pow-2 padding
        # beats the fixed-B server's pad-to-16
        args.n, args.p, args.nnz = 30, 128, 8
        args.num_queries, args.num_lambdas = 40, 6
        args.b_max = 16
        args.check_masks = 0            # replay every query
        args.mode = "compare"

    dtype = np.float64 if args.x64 else np.float32
    stream = QueryStream(n=args.n, p=args.p, batch=args.b_max,
                         nnz=args.nnz, corr=args.corr, seed=args.seed)
    with cli.mesh_world(args, device) as mesh:
        if mesh is not None and args.arrival_rate > 0 \
                and torch.distributed.get_world_size() > 1:
            # the ranks would form batches from their own wall clocks and
            # could dispatch different batches into the same collectives
            raise SystemExit("--arrival-rate > 0 needs one rank: every rank "
                             "of a mesh runs the same loop on its own clock")
        return _serve(args, stream, dtype, device, mesh)


def _serve(args, stream, dtype, device, mesh) -> dict:
    say = print if cli.is_main_process() else (lambda *a, **k: None)

    # ---- fit the dictionary ONCE (on the device, shared by every batch)
    t0 = time.perf_counter()
    X = stream.dictionary(dtype=dtype)
    cfg = cli.path_config(args, solver_tol=args.solver_tol)
    sess = LassoSession.fit(torch.from_numpy(X) if args.x64 else X,
                            mesh=mesh, config=cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    say(f"dictionary fitted once in {time.perf_counter() - t0:.3f}s "
        f"(fused passes: {sess.fit_passes}); n={args.n} p={args.p} "
        f"B_max={args.b_max} K={args.num_lambdas}")

    if args.mode != "compare":
        _run_arm(args, sess, stream, args.mode, dtype)      # warm-up
        report = _run_arm(args, sess, stream, args.mode, dtype,
                          progress=True)
        if cli.is_main_process():
            _print_report(args.mode, report)
        return {"reports": {args.mode: report}, "session": sess}

    # ---- compare mode: fixed-B baseline vs continuous batching ----------
    # warm every batch shape both arms will touch, then time each arm
    # best-of-R on identical replayed streams (runs interleaved so drift
    # hits both arms alike)
    _run_arm(args, sess, stream, "fixed", dtype)
    _run_arm(args, sess, stream, "continuous", dtype)
    rep_fixed = rep_cont = None
    for _ in range(max(args.repeats, 1)):
        rf = _run_arm(args, sess, stream, "fixed", dtype)
        rc = _run_arm(args, sess, stream, "continuous", dtype)
        if rep_fixed is None or rf.queries_per_sec > rep_fixed.queries_per_sec:
            rep_fixed = rf
        if rep_cont is None or rc.queries_per_sec > rep_cont.queries_per_sec:
            rep_cont = rc
    if cli.is_main_process():
        _print_report("fixed", rep_fixed)
        _print_report("continuous", rep_cont)

    reports = {"fixed": rep_fixed, "continuous": rep_cont}
    mismatched = {mode: _mask_mismatches(sess, rep, args.check_masks)
                  for mode, rep in reports.items()}
    masks_ok = {mode: not qids for mode, qids in mismatched.items()}
    ratio = rep_cont.queries_per_sec / max(rep_fixed.queries_per_sec, 1e-12)
    say(f"continuous vs fixed queries/sec: {ratio:.2f}x; per-query masks "
        f"bit-identical to direct session.path: {masks_ok}")
    if args.quick:
        # continuous batching must not lose throughput to the fixed-B
        # server at steady-state load, and every served mask must equal
        # the direct session.path answer
        assert all(masks_ok.values()), masks_ok
        assert rep_cont.queries_per_sec >= rep_fixed.queries_per_sec, (
            rep_cont.queries_per_sec, rep_fixed.queries_per_sec)

    if args.bench_json is not None and cli.is_main_process():
        sl.merge_bench_section(
            args.bench_json, "bench_serve",
            meta={"n": args.n, "p": args.p, "nnz": args.nnz,
                  "num_queries": args.num_queries,
                  "num_lambdas": args.num_lambdas, "b_max": args.b_max,
                  "deadline_ms": args.deadline_ms,
                  "queue_cap": args.queue_cap, "rule": args.rule,
                  "solver": args.solver, "backend": args.backend or "auto",
                  "solver_tol": args.solver_tol, "quick": bool(args.quick),
                  "device": (torch.cuda.get_device_name(device)
                             if device.type == "cuda" else "cpu")},
            rows=[_bench_row(args, "fixed", rep_fixed, masks_ok["fixed"]),
                  _bench_row(args, "continuous", rep_cont,
                             masks_ok["continuous"])])
        say(f"wrote {args.bench_json}")
    return {"reports": reports, "session": sess, "mismatched": mismatched,
            "masks_identical": masks_ok, "ratio": ratio}


if __name__ == "__main__":
    main()
