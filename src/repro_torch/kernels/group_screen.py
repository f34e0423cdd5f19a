"""Group screening kernel: ``gscores[g] = ‖X_gᵀc‖₂`` over contiguous groups.

``group_screen_scores(X, centre, m)`` takes X (n, p) with p % m == 0 and a
rank-1 centre (n,), and returns the (p/m,) group scores (Corollary 21's
left-hand side). With ``wide_p`` the block X of whole groups is summed
as the pass over a wider X of ``wide_p`` columns sums it
(:func:`group_wide_plan`): a mesh rank's block gives the whole width's
bits. Replaces ``group_screen_scores`` of
``src/repro/kernels/group_screen.py`` (its ``pl.pallas_call`` at line
68). A CPU X takes the plain version of :mod:`.ref`; a CUDA X launches
``csrc/group_screen.cu`` (float32, contiguous) or raises.

Bound on an H100: the pass reads X once (n·p·4 bytes) for 2 flops per
element, so it is bound by the bytes of X at 3.35 TB/s (200 MB at
250 × 200 000: 60 µs). The kernel is the screens' column pass
(``csrc/colpass.cuh``) with a GROUP epilogue: :func:`group_plan` cuts the
columns into tiles of whole groups, the tile's dots stay in shared memory
and one thread per group adds their squares, so the p dots never reach
device memory. Measured on an NVIDIA H100 80GB HBM3 at 700 W
(``chip_smoke.py --kernels``, ``PERF.md`` §6): 0.074 ms at 250 × 200 000,
m = 10, 80 % of the byte bound, against 0.084 ms for ``torch.matmul(c,
X)`` alone and 0.152 ms for the earlier 32-column design.
"""

from __future__ import annotations

import collections
import functools
import math

import torch

from . import cost, ref
from .edpp_screen import (CLUSTER, MAX_SPLIT, LaunchPlan, _cdiv, check_error,
                          check_rows, check_x, cluster_split, finish_plan,
                          kernel_fn, sms_of)

LAUNCHES: collections.Counter = collections.Counter()
GROUP_SPAN = 128   # columns a step of the group pass (colpass::GROUP_SPAN)


@functools.lru_cache(maxsize=4096)
def group_plan(n: int, p: int, m: int, sms: int, aligned: bool,
               max_split: int = CLUSTER) -> LaunchPlan:
    """The launch of one group pass over X (n, p), groups of m columns, on
    a card with ``sms`` SMs; ``aligned``: X's base pointer is 16-byte
    aligned. Every tile holds whole groups:

    - lcm(m, 4) ≤ 128: the largest multiple of lcm(m, 4) up to 128 columns
      (120 for m = 5, 10, 20), float4 loads where p % 4 == 0 and X is
      aligned, else scalar loads of the same columns;
    - m ≤ 128 < lcm(m, 4) (m = 33, say): the largest multiple of m up to
      128, with scalar loads (the tiles do not start on 16 bytes);
    - m > 128: one group a tile, walked in steps of 128 columns (one pass
      over the rows each), float4 where m % 4 == 0 and X is aligned.

    Where the tiles alone leave SMs idle, the rows of a one-step tile are
    split over a cluster as in ``launch_plan`` (``cluster_split``), halved
    until each rank's share of the epilogue (tile / split columns) holds
    whole groups. The centre is staged as in ``launch_plan`` for B = 1;
    the partials take ``GROUP_SPAN`` columns a warp.
    """
    if (n < 0 or p < 1 or m < 1 or p % m or sms < 1
            or not 1 <= max_split <= MAX_SPLIT):
        raise ValueError(f"group_plan: no plan for n={n}, p={p}, m={m}, "
                         f"sms={sms}")
    step = math.lcm(m, 4)
    if step <= GROUP_SPAN:
        tile, vec = GROUP_SPAN // step * step, 4
    elif m <= GROUP_SPAN:
        tile, vec = GROUP_SPAN // m * m, 1
    else:
        tile, vec = m, 4 if m % 4 == 0 else 1
    vec = vec if aligned and p % 4 == 0 else 1
    split = 1
    if _cdiv(p, tile) < sms and tile <= GROUP_SPAN:
        split = cluster_split(n, _cdiv(p, tile), sms, max_split)
        while tile % split or tile // split % m:
            split //= 2
    return finish_plan(n, p, 1, vec, tile, split, GROUP_SPAN)


def group_wide_plan(n: int, p: int, wide_p: int, m: int, sms: int,
                    aligned: bool) -> LaunchPlan:
    """The plan of a group pass over an (n, p) block of whole groups of a
    wider X with ``wide_p`` columns (a mesh rank's block) that sums each
    group as the pass over all ``wide_p`` columns sums it: that pass's
    tile and cluster (the row split, the fold of warps and ranks, the
    epilogue's share; none depends on the loads), with the block's own
    loads and grid. The tile depends on m alone, so only the cluster can
    differ from the block's own plan: where p/tile tiles leave SMs idle
    and wide_p/tile tiles do not, the block's own plan splits the rows
    and sums them in another order."""
    if wide_p < p or wide_p % m:
        raise ValueError(f"group_wide_plan: wide_p={wide_p} must be a "
                         f"multiple of m={m} and at least p={p}")
    wide = group_plan(n, wide_p, m, sms, aligned)
    own = group_plan(n, p, m, sms, aligned)
    return finish_plan(n, p, 1, own.vec, wide.tile, wide.split, GROUP_SPAN)


def group_plan_for(X: torch.Tensor, m: int,
                   wide_p: int | None = None) -> LaunchPlan:
    """:func:`group_plan` for a CUDA X; with ``wide_p``,
    :func:`group_wide_plan` for a block of a wider X."""
    n, p = X.shape
    aligned = X.data_ptr() % 16 == 0
    if wide_p is not None:
        return group_wide_plan(n, p, wide_p, m, sms_of(X), aligned)
    return group_plan(n, p, m, sms_of(X), aligned)


def group_screen_scores(X: torch.Tensor, centre: torch.Tensor, m: int, *,
                        plan: LaunchPlan | None = None,
                        wide_p: int | None = None) -> torch.Tensor:
    """``‖X_gᵀ·centre‖₂`` for the p/m contiguous groups of m columns.
    ``wide_p``: X is a block of whole groups of an X with ``wide_p``
    columns, and each group is summed as that X's pass sums it
    (:func:`group_wide_plan`). ``plan`` replaces either choice on a CUDA
    X."""
    op = "group_screen_scores"
    m = int(m)
    p = X.shape[-1]
    if m < 1 or p % m:
        raise ValueError(f"{op}: the group size m={m} must divide p={p}")
    if X.device.type == "cpu":
        return ref.group_screen_ref(X, centre, m, wide_p=wide_p)
    check_x(X, op)
    n = X.shape[0]
    if centre.dim() != 1:
        raise ValueError(f"{op}: the centre must be rank 1 ({n},), got "
                         f"{tuple(centre.shape)}")
    C, _ = check_rows(X, centre, n, "centre", op)
    fn = (None if cost.is_fake(X)
          else kernel_fn("group_screen", "group_screen_scores_f32"))
    out = torch.empty((p // m,), dtype=torch.float32, device=X.device)
    if p and fn is None:
        cost.charge(op, cost.group_pass(n, p, m))
    elif p:
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream().cuda_stream
            pl = plan or group_plan_for(X, m, wide_p)
            check_error(fn(X.data_ptr(), C.data_ptr(), n, p, m, *pl.c_args,
                           out.data_ptr(), stream), op)
            LAUNCHES[op] += 1
    return out
