"""Group screening kernel: ``gscores[g] = ‖X_gᵀc‖₂`` over contiguous groups.

``group_screen_scores(X, centre, m)`` takes X (n, p) with p % m == 0 and a
rank-1 centre (n,), and returns the (p/m,) group scores (Corollary 21's
left-hand side). Replaces ``group_screen_scores`` of
``src/repro/kernels/group_screen.py`` (its ``pl.pallas_call`` at line
68). A CPU X takes the plain version of :mod:`.ref`; a CUDA X launches
``csrc/group_screen.cu`` (float32, contiguous) or raises.

Bound on an H100: the pass reads X once (n·p·4 bytes) for 2 flops per
element, so it is bound by the bytes of X at 3.35 TB/s (200 MB at
250 × 200 000: 60 µs). The kernel keeps colpass's layout (32 lanes on 32
consecutive columns, row phases summed in a fixed order) and cuts each
block's columns on group boundaries, so the per-group sum of squares
stays inside the block and the p dots never reach device memory.
"""

from __future__ import annotations

import collections

import torch

from . import ref
from .edpp_screen import check_error, check_rows, check_x, kernel_fn

LAUNCHES: collections.Counter = collections.Counter()


def group_screen_scores(X: torch.Tensor, centre: torch.Tensor,
                        m: int) -> torch.Tensor:
    """``‖X_gᵀ·centre‖₂`` for the p/m contiguous groups of m columns."""
    op = "group_screen_scores"
    m = int(m)
    p = X.shape[-1]
    if m < 1 or p % m:
        raise ValueError(f"{op}: the group size m={m} must divide p={p}")
    if X.device.type == "cpu":
        return ref.group_screen_ref(X, centre, m)
    check_x(X, op)
    n = X.shape[0]
    if centre.dim() != 1:
        raise ValueError(f"{op}: the centre must be rank 1 ({n},), got "
                         f"{tuple(centre.shape)}")
    C, _ = check_rows(X, centre, n, "centre", op)
    fn = kernel_fn("group_screen", "group_screen_scores_f32")
    out = torch.empty((p // m,), dtype=torch.float32, device=X.device)
    if p:
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream().cuda_stream
            check_error(fn(X.data_ptr(), C.data_ptr(), n, p, m,
                           out.data_ptr(), stream), op)
            LAUNCHES[op] += 1
    return out
