"""Shared CLI wiring for the launch drivers (``solve.py``, ``serve.py``),
the reference's ``src/repro/launch/cli.py`` on the port's sessions:

  * :func:`add_problem_args`  ``--n --p --nnz --corr --seed``
  * :func:`add_engine_args`   ``--rule --solver --backend
                              --solver-backend --screen-dtype --solve-dtype``
  * :func:`add_serve_args`    the continuous-batching policy flags
  * :func:`add_mesh_arg`      ``--mesh QxF``
  * :func:`add_x64_arg`       ``--x64 / --no-x64``
  * :func:`add_device_arg`    ``--device`` (default ``cuda``)
  * :func:`setup_device`      the device the run takes, after refusing
                              ``--x64`` on the card
  * :func:`mesh_world`        the ``("query", "feature")`` mesh of
                              ``--mesh``, with a one-rank process group
                              where none is up
  * :func:`path_config`       a :class:`repro_torch.PathConfig` from the
                              flags

The reference's ``setup_jax`` has no counterpart: the port has no global
float64 switch. ``--x64`` means float64 arrays, which the port solves
with the plain versions on CPU tensors only, so with a CUDA device it
exits. ``--backend`` and ``--solver-backend`` take the port's backend
names (``cuda|torch``, :mod:`repro_torch.kernels.ops`).
"""

from __future__ import annotations

import argparse
import contextlib
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..core import PathConfig, ScreenSpec, SolveSpec
from ..core.device import resolve_device
from ..kernels import ops


def add_problem_args(ap: argparse.ArgumentParser, *, n: int, p: int,
                     nnz: int, corr: float = 0.0, seed: int = 0) -> None:
    """Synthetic problem shape flags (paper §4.1.2 recipe, eq. 74)."""
    ap.add_argument("--n", type=int, default=n)
    ap.add_argument("--p", type=int, default=p)
    ap.add_argument("--nnz", type=int, default=nnz)
    ap.add_argument("--corr", type=float, default=corr)
    ap.add_argument("--seed", type=int, default=seed)


def add_engine_args(ap: argparse.ArgumentParser, *, rule: str = "edpp",
                    solver: str = "fista") -> None:
    """Screen/solve spec flags, shared by solve and serve. A rule, strategy
    or dtype the port does not serve yet raises where the session raises,
    naming its ROADMAP.md item."""
    ap.add_argument("--rule", default=rule,
                    help="screening rule (edpp|dpp|imp1|imp2|seq_safe|safe|"
                         "none; strong on group sessions)")
    ap.add_argument("--solver", default=solver,
                    help="any registered solver strategy (fista|cd|"
                         "group_fista)")
    ap.add_argument("--backend", choices=tuple(ops.BACKENDS), default=None,
                    help="screening backend (default: follow the device)")
    ap.add_argument("--solver-backend", choices=tuple(ops.BACKENDS),
                    default=None,
                    help="solver backend (default: follow the device)")
    ap.add_argument("--screen-dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="dtype of the X copy the screens stream "
                         "(bfloat16: ROADMAP.md queue 1 item 9, not ported)")
    ap.add_argument("--solve-dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="dtype of the FISTA iteration matvec stream "
                         "(bfloat16: ROADMAP.md queue 1 item 9, not ported)")


def add_serve_args(ap: argparse.ArgumentParser, *, b_max: int = 8,
                   deadline_ms: float = 20.0, queue_cap: int = 64) -> None:
    """Continuous-batching policy flags (:class:`.serve_loop.ServePolicy`).
    ``--batch-size`` is an alias of ``--b-max``."""
    ap.add_argument("--b-max", "--batch-size", dest="b_max", type=int,
                    default=b_max,
                    help="fill target B_max: dispatch as soon as this many "
                         "queries are queued (alias --batch-size)")
    ap.add_argument("--deadline-ms", type=float, default=deadline_ms,
                    help="admission deadline: a partial batch dispatches "
                         "once its oldest query has waited this long")
    ap.add_argument("--queue-cap", type=int, default=queue_cap,
                    help="bounded admission queue; a full queue pushes "
                         "back on the arrival source")
    ap.add_argument("--max-in-flight", type=int, default=2,
                    help="pipelined dispatch window (batch k+1 forms while "
                         "batch k computes)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="offered load in queries/sec (0 = every query "
                         "arrives at t=0, the steady-state bench shape)")
    ap.add_argument("--mode", choices=("continuous", "fixed", "compare"),
                    default="continuous",
                    help="continuous batching, the fixed-B server, or a "
                         "timed compare of both (--quick implies compare)")


def add_mesh_arg(ap: argparse.ArgumentParser) -> None:
    """``--mesh QxF``: fit the session on a ``("query", "feature")`` mesh,
    X split by columns over F ranks, one process per rank: Q·F must equal
    the world size (``torchrun --nproc-per-node=Q·F``; a single process
    runs ``1x1``)."""
    ap.add_argument("--mesh", default=None, metavar="QxF",
                    help="2D mesh 'QxF' (e.g. 1x4): Q query ranks × F "
                         "feature ranks (default: no mesh)")


def add_x64_arg(ap: argparse.ArgumentParser, *, default: bool | None
                ) -> None:
    """``--x64 / --no-x64``: float64 arrays (plain versions, CPU only).
    ``default=None`` follows the device: float64 on the CPU, float32 on
    the card."""
    ap.add_argument("--x64", action=argparse.BooleanOptionalAction,
                    default=default,
                    help="float64 problems, solved with the plain versions "
                         "on the CPU only (default: serve off; solve on "
                         "with --device cpu, off on the card)")


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="where the session runs: cuda (default; raises "
                         "without a card) or cpu")


def setup_device(args):
    """The ``torch.device`` of ``--device``, with ``args.x64`` resolved.
    ``--x64`` with a CUDA device exits; without a card ``cuda`` raises
    (:func:`repro_torch.core.device.resolve_device`): no run falls back to
    the CPU."""
    on_card = torch.device(args.device).type == "cuda"
    if args.x64 is None:
        args.x64 = not on_card
    if args.x64 and on_card:
        raise SystemExit(
            "--x64 runs float64 through the plain versions, which take CPU "
            "tensors only: use --device cpu, or --no-x64 on the card")
    return resolve_device(args.device)


def _parse_mesh(spec: str) -> tuple[int, int]:
    try:
        q, f = (int(t) for t in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh expects 'QxF' (e.g. 1x4), got {spec!r}")
    if q < 1 or f < 1:
        raise SystemExit(f"--mesh axes must be ≥ 1, got {spec!r}")
    return q, f


@contextlib.contextmanager
def mesh_world(args, device):
    """The :class:`~torch.distributed.device_mesh.DeviceMesh` of ``--mesh``
    (None without the flag). Q·F must equal the world size: that of the
    process group already up, else of ``torchrun`` (its ``WORLD_SIZE``),
    else 1. Where no group is up this starts one (gloo on the CPU, NCCL on
    the card; ``torchrun``'s rendezvous, or a one-rank group in memory)
    and destroys it on exit."""
    spec = getattr(args, "mesh", None)
    if spec is None:
        yield None
        return
    q, f = _parse_mesh(spec)
    own = not dist.is_initialized()
    world = (int(os.environ.get("WORLD_SIZE", "1")) if own
             else dist.get_world_size())
    if q * f != world:
        raise SystemExit(
            f"--mesh {spec} needs {q * f} processes, one per rank, and this "
            f"run has {world}: launch with torchrun --nproc-per-node={q * f}")
    if own:
        kw = {}
        if device.type == "cuda":
            if device.index is None:
                device = torch.device(
                    "cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
            kw["device_id"] = device
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:           # under torchrun
            dist.init_process_group(backend, init_method="env://", **kw)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, **kw)
    try:
        yield init_device_mesh(device.type, (q, f),
                               mesh_dim_names=("query", "feature"))
    finally:
        if own:
            dist.destroy_process_group()


def is_main_process() -> bool:
    """Rank 0, or no process group: the one process that prints and
    writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def path_config(args, *, solver_tol: float | None = None, **extra):
    """The session :class:`~repro_torch.PathConfig` from the shared flags;
    ``extra`` is merged as flat keywords (e.g. ``checkpoint_fn=...``)."""
    solve_kw = {"strategy": args.solver, "backend": args.solver_backend,
                "solve_dtype": getattr(args, "solve_dtype", "float32")}
    if solver_tol is not None:
        solve_kw["tol"] = solver_tol
    return PathConfig(
        screen=ScreenSpec(rule=args.rule,
                          backend=getattr(args, "backend", None),
                          screen_dtype=getattr(args, "screen_dtype",
                                               "float32")),
        solve=SolveSpec(**solve_kw), **extra)
