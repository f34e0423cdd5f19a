"""Fault tolerance for long runs (training loops and λ-paths), the
reference's ``src/repro/runtime/elastic.py`` over
:mod:`repro_torch.checkpoint`.

The failure model: a worker dies mid-run. Recovery contract:

  1. every state mutation passes through the checkpoint module (atomic
     commits);
  2. batch content is a pure function of (seed, step, shard)
     (:class:`repro_torch.data.SyntheticLM`), so a replacement worker
     regenerates its shard exactly;
  3. :func:`run_elastic` drives the loop: on failure it asks
     ``make_mesh`` for the mesh of the next attempt (possibly smaller:
     :func:`repro_torch.launch.mesh.make_mesh_for` of the survivors),
     restores the latest checkpoint under the new mesh's shardings and
     resumes from the last committed step.

On a mesh every process of the world runs the driver (one process per
rank): a rank that the next attempt's mesh leaves out returns at once
(``RunReport.left``), and a sharded state is checkpointed through
``checkpoint.save(..., shardings=)`` (``shardings_fn``). Here the
failure signal is an injected :class:`SimulatedFailure`, raised by every
rank at the same step; a real multi-card run would raise it on a
collective timeout.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

from ..checkpoint import checkpoint as ckpt

log = logging.getLogger("repro_torch.runtime")


class SimulatedFailure(RuntimeError):
    """Injected device/worker loss (stands in for the coordination event)."""


@dataclasses.dataclass
class ElasticConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    max_restarts: int = 10
    keep: int = 3


@dataclasses.dataclass
class RunReport:
    steps_done: int
    restarts: int
    wall_s: float
    mesh_history: list
    left: bool = False          # this rank is outside the last mesh


def run_elastic(
    cfg: ElasticConfig,
    *,
    make_mesh: Callable[[int], object],
    init_fn: Callable,          # (mesh) -> state            (fresh start)
    restore_fn: Callable,       # (mesh, step) -> state      (from checkpoint)
    step_fn: Callable,          # (mesh, state, step) -> state
    save_fn: Callable,          # (state, step) -> pytree to checkpoint
    total_steps: int,
    shardings_fn: Callable | None = None,   # (mesh) -> save_fn's layouts
) -> RunReport:
    """Generic elastic driver. ``make_mesh(attempt)`` may return a smaller
    mesh on later attempts (degraded capacity); with ``shardings_fn`` the
    checkpoints are saved from every rank's shards."""
    t0 = time.perf_counter()
    restarts = 0
    meshes = []
    step = 0
    while True:
        mesh = make_mesh(restarts)
        meshes.append(getattr(mesh, "shape", None))
        last = ckpt.latest_step(cfg.ckpt_dir)
        if hasattr(mesh, "get_coordinate") and mesh.get_coordinate() is None:
            log.info("rank outside the mesh %s: leaving", meshes[-1])
            return RunReport(last or 0, restarts, time.perf_counter() - t0,
                             meshes, left=True)
        if last is None:
            state = init_fn(mesh)
            step = 0
        else:
            state = restore_fn(mesh, last)
            step = last
            log.info("restored step %d on mesh %s", last, meshes[-1])
        try:
            while step < total_steps:
                state = step_fn(mesh, state, step)
                step += 1
                if step % cfg.ckpt_every == 0 or step == total_steps:
                    ckpt.save(cfg.ckpt_dir, step, save_fn(state, step),
                              keep=cfg.keep, shardings=None if shardings_fn
                              is None else shardings_fn(mesh))
            return RunReport(step, restarts, time.perf_counter() - t0, meshes)
        except SimulatedFailure as e:
            restarts += 1
            log.warning("worker failure at step %d (%s); restart %d",
                        step, e, restarts)
            if restarts > cfg.max_restarts:
                raise RuntimeError("restart budget exhausted") from e
