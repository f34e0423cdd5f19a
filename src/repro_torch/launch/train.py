"""LM training entry point, the reference's ``src/repro/launch/train.py``
on the port's train step.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --tiny \\
        --steps 20 --seq 64 --batch 4 [--ckpt-dir DIR] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch yi-9b --tiny --mesh 2x2 [--device cpu]

Any registered architecture is selectable with ``--arch``; ``--tiny``
takes its reduced config. All ten build: the dense, MoE/MLA, hybrid
Mamba2 (zamba2) and xLSTM architectures. It runs on the card unless
``--device cpu``.

``--mesh`` takes any shape, its axes named ``("pod", "data",
"model")[-len(shape):]`` as in the reference; the state is sharded over
it (:mod:`repro_torch.train.steps`), one process per rank, so the
product must equal the world size under ``torchrun``. A single process
takes a mesh of size 1 (the default ``1x1``) on a process group of one
rank (NCCL on the card, gloo on the CPU). Only rank 0 prints.

Checkpoints are written in the reference's layout (stacked segments,
:func:`repro_torch.convert.train_state_to_reference`), whole whatever
the mesh, so a run resumes from a checkpoint of either package and of
any mesh.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from .. import configs
from ..checkpoint import latest_step, restore, save
from ..convert import (shardings_to_reference, train_state_from_reference,
                       train_state_to_reference)
from ..core.device import resolve_device
from ..data import SyntheticLM, device_batch
from ..optim import adamw
from ..pshard import MeshShape
from ..train import steps as ST
from . import cli
from .mesh import make_mesh, mesh_axes


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCHS))
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    cli.add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None):
    """Train, print the reference's lines (rank 0), and return ``(state,
    losses)``: the final :class:`~repro_torch.train.TrainState` (this
    rank's shards) and ``{step: loss}`` of the steps this run took."""
    args = _parse_args(argv)
    try:
        shape = tuple(int(x) for x in args.mesh.lower().split("x"))
        names = mesh_axes(shape)
    except ValueError:
        raise SystemExit(f"--mesh expects e.g. 1x1, 2x2 or 2x16x16, got "
                         f"{args.mesh!r}")
    with cli.process_world(math.prod(shape), args.mesh,
                           resolve_device(args.device)) as device:
        return _train(args, shape, make_mesh(MeshShape(names, shape),
                                             device.type), device)


def _train(args, shape, mesh, device):
    say = print if cli.is_main_process() else (lambda *a, **k: None)
    cfg = configs.get_tiny(args.arch) if args.tiny \
        else configs.get_config(args.arch)
    tc = ST.TrainConfig(accum_steps=args.accum, opt=adamw.OptConfig(
        lr=args.lr, warmup_steps=max(args.steps // 10, 2),
        total_steps=max(args.steps, 100)))

    state, state_sh = ST.init_state(0, cfg, tc, mesh)
    n = sum(math.prod(lay.shape) for lay in state_sh.params.values())
    say(f"{cfg.name}: {n/1e6:.1f}M params on mesh {shape}")

    src = SyntheticLM(vocab=cfg.vocab, seq=args.seq,
                      global_batch=args.batch, frontend=cfg.frontend,
                      d_frame=cfg.d_frame, d_patch=cfg.d_patch,
                      n_img_tokens=cfg.n_img_tokens)
    bsh = ST.batch_shardings(mesh, cfg, "train", src.host_batch(0))
    step_fn = ST.make_train_step(cfg, tc, mesh, state_sh, bsh)
    ref_sh = shardings_to_reference(state_sh)

    start = 0
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            tree, _ = restore(args.ckpt_dir, last,
                              train_state_to_reference(state), device="cpu",
                              shardings=ref_sh)
            state = train_state_from_reference(tree, cfg, device=device)
            start = last
            say(f"resumed from step {last}")

    losses = {}
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        batch = device_batch(mesh, src.host_batch(i), args.accum)
        state, metrics = step_fn(state, batch)
        losses[i] = float(metrics["loss"])
        if i % 5 == 0 or i == args.steps - 1:
            say(f"step {i:4d} loss {losses[i]:7.4f} "
                f"lr {float(metrics['lr']):.2e}")
        if args.ckpt_dir and ((i + 1) % args.ckpt_every == 0
                              or i == args.steps - 1):
            save(args.ckpt_dir, i + 1, train_state_to_reference(state),
                 shardings=ref_sh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    say(f"{args.steps - start} steps in {dt:.1f}s "
        f"({(args.steps - start) * args.batch * args.seq / dt:,.0f} tok/s)")
    return state, losses


if __name__ == "__main__":
    main()
