"""Solver loops replayed from CUDA graphs.

A FISTA iteration on the card is a handful of small launches: a fit, a
collective or two, a gradient and the fused prox kernel. Launched from
Python one by one, the host sets the pace, several times the device's
own time per iteration. The reference runs its distributed FISTA as one
device program (a ``jax.lax.scan`` over the iteration,
``src/repro/core/distributed.py:dist_fista``); here a block of ``block``
iterations is captured once with :func:`torch.cuda.graph` and replayed,
so the launches come from the device and the host issues one replay per
block.

* :func:`param_table` holds each iteration's step | λ | mom as a row of
  an ``(iters, 3, B)`` table. The momentum sequence depends only on the
  iteration count, so it is computed once on the host
  (:func:`~repro_torch.core.solver.momentum_sequence`, in the loop's own
  rounding) and uploaded in one copy; a captured launch reads its row
  through the kernels' ``params`` pointer instead of by value.
* :func:`run_loop` runs ``state = body(state, row)`` over the table's
  rows: on the CPU (or with ``capture=False``) one call per row; on the
  card the first ``1 + (iters − 1) % block`` rows eagerly, on a side
  stream (the capture's warm-up: the process group's communicator, the
  cuBLAS handles and the kernels' libraries exist before capture), then
  ``(iters − 1) // block`` replays of one captured block. The loop state
  lives in static buffers; the block ends by copying its outputs into
  them. Before each replay one ``copy_`` refills the block's rows of
  the table. Eager and replayed iterations run the same kernels on the
  same parameter rows, so their bits agree.

Launch counts stay honest (``kernels.ops.launch_counts``): the capture
runs nothing, so what it counted is taken back, and each replay adds the
launches one block recorded. A capture that fails raises; there is no
fallback to the eager loop.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..kernels import ops
from .solver import host_float, momentum_sequence

#: Iterations per captured block. The eager prefix and the capture each
#: cost about an eager iteration per iteration of the block, so a short
#: block wastes less of a 500-iteration solve; each replay must still
#: keep the host ahead of the device. Measured on an NVIDIA H100 80GB
#: HBM3 at 700 W (``chip_smoke.py`` phase 9, PERF.md §6), ms per
#: iteration at 784 × 50 000 in two runs, "chunked": 0.17–0.24 for
#: K = 1, 5 and 10, 0.25–0.29 for 25, 0.36–0.41 for 50; "none":
#: 0.13–0.16 for K ≤ 10, 0.18–0.21 for 50. Between 1 and 10 the host's
#: noise decides; K = 5 keeps five iterations of device work per replay
#: where an iteration is short.
BLOCK = 5

Body = Callable[[tuple[torch.Tensor, ...], torch.Tensor],
                tuple[torch.Tensor, ...]]


def param_table(iters: int, step: float, lam, batch: int,
                X: torch.Tensor) -> torch.Tensor:
    """The ``(iters, 3, batch)`` table of step | λ | mom rows in X's dtype
    on X's device. ``step`` is a host number, ``lam`` a host number, a
    host (batch,) array or a (batch,) tensor; the momentum comes from
    :func:`momentum_sequence` in the loop's host rounding
    (``host_float(X)``)."""
    on_device = isinstance(lam, torch.Tensor)
    host = np.empty((iters, 3, batch), dtype=np.float64)
    host[:, 0] = step
    host[:, 1] = 0.0 if on_device else np.asarray(lam, dtype=np.float64)
    host[:, 2] = momentum_sequence(iters, host_float(X))[:, None]
    table = torch.from_numpy(host).to(device=X.device, dtype=X.dtype)
    if on_device:
        table[:, 1] = lam.to(device=X.device, dtype=X.dtype)
    return table


def _eager(body: Body, state, rows) -> tuple[torch.Tensor, ...]:
    for row in rows:
        state = body(state, row)
    return state


def run_loop(body: Body, state: Sequence[torch.Tensor], table: torch.Tensor,
             *, capture: bool = True) -> tuple[torch.Tensor, ...]:
    """``state = body(state, table[i])`` for every row of ``table``, in
    captured blocks of :data:`BLOCK` rows (read at the call); see the
    module doc. ``body`` must not synchronise with the host (no
    ``.item()``, no host copies) and must return tensors shaped like its
    state. Returns the final state."""
    block = BLOCK
    state = tuple(state)
    iters = table.shape[0]
    blocks = (iters - 1) // block if capture and table.is_cuda else 0
    if not blocks:
        return _eager(body, state, table)
    eager = iters - blocks * block
    main = torch.cuda.current_stream(table.device)
    side = torch.cuda.Stream(device=table.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        state = _eager(body, state, table[:eager])
    main.wait_stream(side)
    static = tuple(s.clone() for s in state)
    rows = table[eager:eager + block].clone()
    torch.cuda.synchronize(table.device)
    launches, plain = ops.launch_counts(), ops.plain_counts()
    graph = torch.cuda.CUDAGraph()
    # thread_local: the process group's watchdog thread may query the
    # events of earlier collectives while this thread captures
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = _eager(body, static, rows)
        for s, o in zip(static, out):
            s.copy_(o)
    # what one block launches; the capture itself launched nothing
    recorded = ({k: v - launches[k] for k, v in ops.launch_counts().items()},
                {k: v - plain[k] for k, v in ops.plain_counts().items()})
    ops.add_counts(*recorded, times=-1)
    for b in range(blocks):
        if b:
            lo = eager + b * block
            rows.copy_(table[lo:lo + block])
        graph.replay()
        ops.add_counts(*recorded)
    return static
