"""Multi-pod dry run, the reference's ``src/repro/launch/dryrun.py`` for
the port: what one rank's step costs on the production meshes, with
nothing allocated and no card needed.

The reference forces 512 host devices, lowers and compiles each step for
the whole mesh and reads XLA's analyses. PyTorch has no HLO: here one
process plays **rank 0 of a fake world** (a ``"fake"`` process group of
256 ranks for (16, 16) ("data", "model"), 512 for (2, 16, 16) ("pod",
"data", "model")), every tensor is a ``FakeTensor`` on the card's device
or the CPU's (shapes and dtypes, no memory), and for every (arch ×
shape) cell of ``configs.cells()`` and the paper's two cells
(``LASSO_CELLS``) it

    1. builds the rank's inputs (:mod:`.specs`: its shards of the state,
       its rows of the batch, their Layouts),
    2. runs the port's own step once (``make_train_step``,
       ``make_prefill_step``, ``make_decode_step`` of
       :mod:`repro_torch.train.steps`, or the ``dist_*`` functions of
       :mod:`repro_torch.core.distributed`): tracing it to the end is the
       pass/fail gate (``trace_s`` in place of ``compile_s``),
    3. counts every aten op it dispatches (:class:`.hlo_cost.CostMode`:
       flops, bytes, collectives by kind and ring-model bytes, the
       hand-written kernels' charged launches) and its peak memory by
       category (:class:`.hlo_cost.MemoryTracker`),
    4. writes one JSON per cell under ``results/dryrun_torch/``
       (restart-safe: a rerun skips a written cell unless ``--force``).

The record keeps the reference's keys. ``xla_cost`` is null (there is no
XLA); ``compile_s`` becomes ``trace_s``; added: ``device``, ``kernels``
(the charged launches of each hand-written kernel), ``dot_flops`` (the
products' share of ``flops``) and ``collectives.contributed`` (calls and
bytes each rank contributes, as ``pshard.collective_counts`` counts
them). The reference's ``--save-hlo`` has no counterpart.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape train_4k --mesh single [--device cpu]

``--device cuda`` claims the card: the fake tensors are CUDA tensors
and the kernels' wrappers charge their launches; nothing is allocated
and no card is needed, but torch must be built with CUDA. ``--device
cpu`` traces the CPU path (the kernels' plain versions). The default is
``cuda`` where torch is built with CUDA, else ``cpu``; each record's
``device`` says which ran.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from .. import configs
from ..models import model as M
from ..train import steps as ST
from . import hlo, hlo_cost
from . import specs as SP
from .mesh import make_production_mesh

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

LASSO_CELLS = {
    # (N, p, fista iters): feature count chosen so X is ~256 MB/chip f32
    "lasso-screen-16m": dict(n=8192, p=1 << 24, iters=0),
    "lasso-fista-16m": dict(n=8192, p=1 << 24, iters=10),
}


def param_counts(cfg) -> tuple[float, float]:
    """(total params, active-per-token params) of ``cfg``, on the meta
    device (no memory): each MoE block's routed experts counted at
    top_k."""
    total = float(M.LM(cfg, device="meta").n_params())
    active = total
    for seg in cfg.segments:
        for blk in seg.blocks:
            if blk.moe is not None:
                e = blk.moe
                per_expert = 3 * e.d_model * e.d_expert
                active -= seg.repeat * (e.n_routed - e.top_k) * per_expert
    return total, active


def model_flops(arch: str, shape_name: str) -> float:
    """MODEL_FLOPS: 6·N_active·D for train, 2·N_active·D for inference
    (forward only), D = processed tokens."""
    cfg = configs.get_config(arch)
    _, active = param_counts(cfg)
    sh = configs.SHAPES[shape_name]
    tokens = sh.batch * (sh.seq if sh.kind != "decode" else 1)
    mult = 6.0 if sh.kind == "train" else 2.0
    return mult * active * tokens


@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a ``"fake"`` process group of ``size``
    ranks: collectives return at once and move nothing. Refused beside a
    real process group; destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run's fake world cannot share a process "
                           "with a real process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _categories(kind: str, args) -> list:
    """The step's arguments as (tree, tracker category) pairs."""
    if kind == "train":
        state, batch = args
        return [(dict(state.params.named_parameters()), "parameters"),
                ((state.opt, state.step), "optimizer"), (batch, "inputs")]
    if kind == "lasso":
        return [(args, "inputs")]
    params, *rest = args
    return [(dict(params.named_parameters()), "parameters"),
            (rest, "inputs")]


def _make_step(kind, cfg, tc, mesh, shardings):
    if kind == "train":
        sshard, bshard = shardings
        return ST.make_train_step(cfg, tc, mesh, sshard, bshard)
    if kind == "prefill":
        pshard, bshard = shardings
        return ST.make_prefill_step(cfg, tc, mesh, pshard, bshard)
    pshard, cshard, tshard = shardings
    return ST.make_decode_step(cfg, tc, mesh, pshard, cshard, tshard)


def _traced(fn, kind: str, args) -> dict:
    """Run ``fn(*args)`` once under the cost model and the memory
    tracker (inside the caller's fake mode)."""
    tracker = hlo_cost.MemoryTracker()
    arg_bytes = sum(tracker.register(tree, cat)
                    for tree, cat in _categories(kind, args))
    keys = tracker.storages(args)
    with hlo_cost.CostMode() as mode, tracker:
        t0 = time.perf_counter()
        out = fn(*args)
        trace_s = time.perf_counter() - t0
    memory = hlo_cost.memory_record(tracker, arg_bytes, out, keys)
    return {"mode": mode, "memory": memory, "trace_s": trace_s}


def trace_step(cfg, shape: configs.ShapeSpec, mesh,
               tc: ST.TrainConfig | None = None, device=None) -> dict:
    """One step of ``cfg`` at ``shape`` traced on fake tensors: on
    ``mesh`` (this rank of a world, e.g. :func:`fake_world`), or on one
    device (``mesh=None``, the unsharded step). Returns {"kind",
    "device", "mode" (the :class:`.hlo_cost.CostMode`), "memory",
    "trace_s"}.

    ``device`` is :func:`.hlo_cost.fake_device`'s. Autograd's engine asks
    the accelerator for a stream when a gradient lies on a CUDA device,
    so a train step on fake CUDA tensors needs a torch built with
    CUDA."""
    tc = tc or ST.TrainConfig()
    dev = hlo_cost.fake_device(device)
    if (shape.kind == "train" and dev.type == "cuda"
            and not torch.backends.cuda.is_built()):
        raise RuntimeError("a train step on fake CUDA tensors needs a torch "
                           "built with CUDA; trace it with device='cpu'")
    with hlo_cost.fake_mode():
        kind, args, shardings = SP.input_specs(cfg, shape, mesh, tc, dev)
        step = _make_step(kind, cfg, tc, mesh, shardings)
        return {"kind": kind, "device": dev.type,
                **_traced(step, kind, args)}


def lasso_call(arch: str, mesh, device=None, *,
               variant: str | None = None, n: int | None = None,
               p: int | None = None):
    """The paper's distributed screening or solver on the rank's block of
    a fake X (n, p/F) over the mesh's F feature ranks, as the reference's
    ``_lower_lasso``: (fn, kind, args) with ``fn(*args)`` the call.

    Screening variants: ``baseline`` (``dist_edpp_screen``: the residual
    and the fused score pass), ``cached_norms``
    (``dist_edpp_screen_cached``: the residual and one matvec pass),
    ``sparse_residual`` (``dist_edpp_screen_sparse``: the residual over
    the active p/16 columns). FISTA: ``dist_fista`` with
    ``overlap="chunked"``, ``capture=False`` (no CUDA graph in a trace).
    λ_next = 0.8, λ_prev = 0.9 of λ_max = 1 (v₁ from the residual); the
    Lipschitz constant 1. ``n`` and ``p`` replace the cell's X."""
    from ..core import distributed as D
    info = LASSO_CELLS[arch]
    n, p, iters = n or info["n"], p or info["p"], info["iters"]
    variant = variant or info.get("variant", "baseline")
    dev = hlo_cost.fake_device(device)
    pl = p // D.feature_size(mesh)

    def f32(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    X, y, beta, v1, norms = f32(n, pl), f32(n), f32(pl), f32(n), f32(pl)
    if iters:
        return (lambda X, y, beta: D.dist_fista(
            mesh, X, y, 0.1, beta, 1.0, iters=iters, overlap="chunked",
            capture=False)), "lasso", (X, y, beta)
    if variant == "baseline":
        return (lambda X, y, beta, v1: D.dist_edpp_screen(
            mesh, X, y, 0.8, 0.9, beta, 1.0, v1)), "lasso", (X, y, beta, v1)
    if variant == "cached_norms":
        return (lambda X, y, beta, v1, norms: D.dist_edpp_screen_cached(
            mesh, X, y, 0.8, 0.9, beta, 1.0, v1, norms)), "lasso", (
            X, y, beta, v1, norms)
    Xa, ba = f32(n, pl // 16), f32(pl // 16)
    return (lambda X, Xa, y, ba, v1, norms: D.dist_edpp_screen_sparse(
        mesh, X, Xa, y, 0.8, 0.9, ba, 1.0, v1, norms)), "lasso", (
        X, Xa, y, ba, v1, norms)


def trace_lasso(arch: str, mesh, device=None, **kw) -> dict:
    """:func:`lasso_call` traced once: {"kind", "device", "mode",
    "memory", "trace_s"}; X and the vectors are the tracker's
    ``inputs``."""
    dev = hlo_cost.fake_device(device)
    with hlo_cost.fake_mode():
        fn, kind, args = lasso_call(arch, mesh, dev, **kw)
        return {"kind": kind, "device": dev.type,
                **_traced(fn, kind, args)}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             tc: ST.TrainConfig | None = None, device=None) -> dict:
    """One cell on a production mesh, traced as rank 0 of a fake world:
    the reference's record (module doc)."""
    chips = 512 if multi_pod else 256
    dev = hlo_cost.fake_device(device)
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=dev.type)
        if arch.startswith("lasso-"):
            traced = trace_lasso(arch, mesh, dev)
        else:
            traced = trace_step(configs.get_config(arch),
                                configs.SHAPES[shape_name], mesh, tc, dev)
        shape = tuple(mesh.shape)
    return cell_record(arch, shape_name, shape, traced)


def cell_record(arch: str, shape_name: str, mesh_shape: tuple[int, ...],
                traced: dict) -> dict:
    """The record of a traced cell (:func:`trace_step`,
    :func:`trace_lasso`) on a mesh of ``mesh_shape``; an LM arch's
    ``params`` and ``model_flops`` are its catalogue config's."""
    chips = math.prod(mesh_shape)
    mode, cost = traced["mode"], traced["mode"].cost
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(map(str, mesh_shape)), "chips": chips,
           "tag": "baseline", "status": "ok", "device": traced["device"],
           "trace_s": round(traced["trace_s"], 2),
           "memory": traced["memory"], "xla_cost": None}
    rl = hlo.roofline_from_cost(cost, chips)
    rec["roofline"] = rl.as_dict()
    rec["roofline"]["hbm_bytes_unfused_upper"] = cost.bytes
    rec["roofline"]["t_memory_upper_s"] = (cost.bytes
                                           / hlo.H100_HBM_BYTES_PER_S)
    rec["collectives"] = {"counts": cost.coll_counts,
                          "bytes_by_kind": cost.coll_bytes_by_kind,
                          "contributed": hlo.contributions(mode.records)}
    rec["kernels"] = mode.kernels
    rec["dot_flops"] = mode.dot_flops
    if not arch.startswith("lasso-"):
        total, active = param_counts(configs.get_config(arch))
        mf = model_flops(arch, shape_name)
        rec["params"] = {"total": total, "active": active}
        rec["model_flops"] = mf
        global_flops = cost.flops * chips
        rec["useful_flops_ratio"] = (mf / global_flops if global_flops
                                     else None)
    return rec


def cell_list(mesh_mode: str):
    cells = []
    for arch, shape, skip in configs.cells():
        for mp in ([False, True] if mesh_mode == "both" else
                   [mesh_mode == "multi"]):
            cells.append((arch, shape, mp, skip))
    for arch in LASSO_CELLS:
        for mp in ([False, True] if mesh_mode == "both" else
                   [mesh_mode == "multi"]):
            cells.append((arch, "lasso", mp, None))
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--device", choices=["cuda", "cpu"],
                    help="the device the fake tensors claim (default: the "
                         "card where torch is built with CUDA, else the "
                         "CPU; nothing is allocated)")
    args = ap.parse_args(argv)
    device = hlo_cost.fake_device(args.device).type
    print(f"[device] the fake tensors claim {device}", flush=True)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        todo = cell_list(args.mesh)
    else:
        if not (args.arch and (args.shape or args.arch.startswith("lasso-"))):
            ap.error("give --all, or --arch with --shape (a lasso-* arch "
                     "takes none)")
        shape = args.shape or "lasso"
        skip = (None if args.arch.startswith("lasso-")
                else configs.cell_skip_reason(args.arch, shape))
        todo = [(args.arch, shape, mp, skip)
                for mp in ([False, True] if args.mesh == "both"
                           else [args.mesh == "multi"])]

    n_ok = n_skip = n_fail = 0
    for arch, shape, mp, skip in todo:
        mesh_tag = "2x16x16" if mp else "16x16"
        fname = os.path.join(args.out, f"{arch}__{shape}__{mesh_tag}.json")
        if os.path.exists(fname) and not args.force:
            print(f"[cached] {arch} {shape} {mesh_tag}")
            n_ok += 1
            continue
        if skip:
            rec = {"arch": arch, "shape": shape, "mesh": mesh_tag,
                   "status": "skipped", "reason": skip}
            print(f"[skip]   {arch} {shape} {mesh_tag}: {skip}")
            n_skip += 1
        else:
            print(f"[trace]  {arch} {shape} {mesh_tag} ...", flush=True)
            try:
                rec = run_cell(arch, shape, mp, device=device)
                rl = rec["roofline"]
                print(f"  ok in {rec['trace_s']}s | peak/dev "
                      f"{rec['memory']['peak_per_device_gb']:.2f} GB"
                      f" | t_comp {rl['t_compute_s']:.3e}s"
                      f" t_mem {rl['t_memory_s']:.3e}s"
                      f" t_coll {rl['t_collective_s']:.3e}s"
                      f" → {rl['dominant']}-bound", flush=True)
                n_ok += 1
            except Exception as e:  # noqa: BLE001 — record and continue
                rec = {"arch": arch, "shape": shape, "mesh": mesh_tag,
                       "status": "error", "error": str(e)[:2000],
                       "traceback": traceback.format_exc()[-4000:]}
                print(f"  FAILED: {e}", flush=True)
                n_fail += 1
        print("[record] " + json.dumps(rec), flush=True)
        with open(fname, "w") as f:
            json.dump(rec, f, indent=1)
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
