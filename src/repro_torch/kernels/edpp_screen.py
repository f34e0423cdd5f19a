"""Screening kernels: the fused EDPP score pass and the screening matvec.

``edpp_screen_scores(X, centre, rho)``
    ``scores[b, j] = |x_jᵀc_b| + ρ_b‖x_j‖`` and ``sumsq[j] = ‖x_j‖²`` in
    one pass over X. Replaces ``edpp_screen_scores`` of
    ``src/repro/kernels/edpp_screen.py`` (its ``pl.pallas_call`` at line
    140). The session runs it once at fit, with a zero centre, for ‖x_j‖².

``screen_matvec(X, centre)``
    ``dot[b, j] = x_jᵀc_b``. Replaces ``screen_matvec`` of the same file
    (``pl.pallas_call`` at line 202); one call attaches each query
    (|Xᵀy|) and one serves every sphere screen on the λ-path. X may be
    the bf16 screen copy (``screen_dtype="bfloat16"``): the centre, the
    sums and the dots stay float32, as in the reference's kernel.

Both take X (n, p) and a centre (n,) or (B, n). A CPU X takes the plain
versions of :mod:`.ref`. A CUDA X launches the kernels of
``csrc/edpp_screen.cu`` (float32, or bf16 for the matvec; contiguous;
built by :mod:`.build`) or raises; there is no fallback.

The mixed-precision screen re-tests a narrow band of columns in float32
on an (n, k) gather of X, and its dots must be the wide float32 pass's
bits at those columns: ``screen_matvec(Xn, c, wide_p=p)`` launches the
gather with the tile and cluster of the pass over all p columns
(:func:`retest_plan`), so each column is summed in the same order. A
dictionary update's added block takes the same plan for its ‖x_j‖² and
|x_jᵀy| (``edpp_screen_scores(X_add, 0, 0, wide_p=p)``,
``screen_matvec(X_add, y, wide_p=p)``), so they are the bits a cold fit
of the edited X gives at those columns.

Bound on an H100: the pass reads X once (n·p·4 bytes) and does 2·B
flops per element, so for B ≤ 8 it is bound by the bytes of X at
3.35 TB/s (157 MB at 784 × 50 000: 47 µs). The TPU kernel carried a
(Bp, bp) accumulator across a sequential grid axis over n; on the card
(``csrc/colpass.cuh``) a CTA of 256 threads owns a tile of columns and a
range of rows, each lane 4 adjacent columns read as one float4 (16-byte
loads: a warp reads 512 contiguous bytes of a row), 4–8 row loads in
flight per thread, the whole centre staged in shared memory once (no
barrier in the streaming loop up to a 96 KB centre), and partial sums
folded in a fixed order without atomics. :func:`launch_plan` picks the
layout from (n, p, B, SMs, alignment): the wide screens take 128-column
tiles, one row range per CTA, and fill the card with column tiles alone;
narrow widths take 32-column tiles whose rows are split over the CTAs of
a thread-block cluster. Measured on an NVIDIA H100 80GB HBM3 at 700 W
(``chip_smoke.py``, ``PERF.md`` §6): ``screen_matvec`` at 784 × 50 000,
one query, 0.0567 ms, 83 % of the byte bound and 0.97× ``torch.matmul(c,
X)`` in the same run (the earlier 32-column design: 0.0985 ms); at
3072 × 99 288, 0.401 ms, 91 % of the bound. On bf16 X the pass reads
n·p·2 bytes (78 MB at 784 × 50 000: 23 µs at 3.35 TB/s), each lane 8
adjacent columns in one 16-byte load, the same tiles and row split.

``LAUNCHES`` counts kernel launches per op (one per launch of up to
``MAX_B`` queries; a larger batch is split into several launches); a
launch on bf16 X counts as ``screen_matvec_bf16``. A CUDA ``FakeTensor``
X (a dry run) launches nothing: the wrappers return fake outputs and
charge each launch's bytes and flops (:mod:`.cost`).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from . import build, cost, ref

MAX_B = 8          # queries per launch (colpass::MAX_B); larger B is split
LAUNCHES: collections.Counter = collections.Counter()

# The column pass's launch constants (csrc/colpass.cuh)
THREADS = 256                 # 8 warps per CTA, every launch
WARPS = THREADS // 32
WIDE_TILE, NARROW_TILE = 128, 32  # columns per CTA: 32 or 8 lanes per row
MAX_SPLIT = 8                 # CTAs per cluster (the portable limit)
CLUSTER = 4                   # the plan's cluster cap (chip_smoke.py sweep)
MIN_SPLIT_ROWS = 64           # rows a CTA of a cluster keeps at least
CENTRE_BUDGET = 96 * 1024     # bytes of centre a CTA stages at once
SMEM_MAX = 232448             # 227 KB: what a CTA may opt in to on sm_90


class LaunchPlan(NamedTuple):
    """How one column pass is launched (``colpass::Plan`` and the grid)."""
    vec: int          # 4: float4 loads; 1: scalar loads (same sums)
    tile: int         # columns per CTA
    split: int        # CTAs per column tile: the cluster, each its own rows
    stage_rows: int   # centre rows staged in shared memory at a time
    grid: tuple[int, int]   # (column tiles, split)
    block: int        # threads per CTA
    smem: int         # dynamic shared memory per CTA, bytes

    @property
    def c_args(self) -> tuple[int, int, int, int]:
        return self.vec, self.tile, self.split, self.stage_rows


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def launch_plan(n: int, p: int, B: int, sms: int, aligned: bool,
                max_split: int = CLUSTER, elem: int = 4) -> LaunchPlan:
    """The launch of one column pass over X (n, p) for B ≤ ``MAX_B``
    queries on a card with ``sms`` SMs; ``aligned``: X's base pointer is
    16-byte aligned; ``elem``: bytes of X's elements (4, or 2 for bf16).

    - 16-byte loads (4 float or 8 bf16 columns a lane, ``vec`` = 16 /
      elem) when p % vec == 0 and X is aligned, else scalar loads of the
      same columns (the sums do not change);
    - 128-column tiles when p / 128 tiles fill every SM (the wide
      screens), else 32-column tiles whose rows are split over a cluster
      of ``split`` CTAs (a power of 2 ≤ ``max_split``) so that about two
      CTAs run on every SM, each with ≥ ``MIN_SPLIT_ROWS`` rows. Neither
      depends on B or on the alignment, so a query's result is the same
      in every batch;
    - the CTA's whole centre staged at once when B·rows·4 bytes fit
      ``CENTRE_BUDGET``, else stages of a multiple of the rows a CTA step
      takes at most (32; bf16 64), so a thread keeps its rows.

    ``max_split`` caps the cluster: ``CLUSTER`` by default (clusters of 8
    were no faster at 784 × 32 and slower at 784 × 512 with 8 queries on
    the H100, PERF.md §6), up to ``MAX_SPLIT``, 1 for none.
    """
    if (n < 0 or p < 1 or not 1 <= B <= MAX_B or sms < 1
            or not 1 <= max_split <= MAX_SPLIT or elem not in (2, 4)):
        raise ValueError(f"launch_plan: no plan for n={n}, p={p}, B={B}, "
                         f"sms={sms}, elem={elem}")
    cols = 16 // elem
    vec = cols if aligned and p % cols == 0 else 1
    if _cdiv(p, WIDE_TILE) >= sms:
        tile, split = WIDE_TILE, 1
    else:
        tile = NARROW_TILE
        split = cluster_split(n, _cdiv(p, tile), sms, max_split)
    return finish_plan(n, p, B, vec, tile, split, tile, quantum=128 // elem)


def retest_plan(n: int, k: int, wide_p: int, B: int, sms: int,
                aligned: bool) -> LaunchPlan:
    """The plan of a float32 pass over an (n, k) gather of X's columns
    that sums each column in the order of the pass over all ``wide_p``
    columns: that pass's tile and cluster (the row split, the lanes of a
    row, the fold of warps and ranks; none depends on B or the loads),
    with the gather's own loads and grid."""
    wide = launch_plan(n, wide_p, B, sms, aligned)
    vec = 4 if aligned and k % 4 == 0 else 1
    return finish_plan(n, k, B, vec, wide.tile, wide.split, wide.tile)


def cluster_split(n: int, tiles: int, sms: int, max_split: int) -> int:
    """CTAs a column tile's rows are split over: a power of 2 ≤
    ``max_split`` that brings the ``tiles`` to about two CTAs an SM, each
    with ≥ ``MIN_SPLIT_ROWS`` rows."""
    want = min(max_split, _cdiv(2 * sms, tiles), max(1, n // MIN_SPLIT_ROWS))
    return 1 << (want.bit_length() - 1)


def finish_plan(n: int, p: int, B: int, vec: int, tile: int, split: int,
                span: int, quantum: int = 32) -> LaunchPlan:
    """The plan with its staged centre and shared memory: the CTA's whole
    centre staged at once when B·rows·4 bytes fit ``CENTRE_BUDGET``, else
    stages of a multiple of ``quantum`` rows; ``span`` columns of partials
    a warp (``colpass::smem_bytes``)."""
    rows = _cdiv(n, split)
    cap = CENTRE_BUDGET // (4 * B) // quantum * quantum
    stage_rows = max(1, rows) if rows <= cap else cap
    centre = _cdiv(B * stage_rows, 4) * 4
    red = WARPS * (B + 1) * span
    smem = 4 * (max(centre, red) if split == 1
                else centre + red + (B + 1) * tile)
    return LaunchPlan(vec, tile, split, stage_rows, (_cdiv(p, tile), split),
                      THREADS, smem)


_SMS: dict[int, int] = {}


def sms_of(X: torch.Tensor) -> int:
    """The SM count of the card that holds the CUDA tensor X."""
    idx = X.device.index if X.device.index is not None else 0
    sms = _SMS.get(idx)
    if sms is None:
        sms = _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return sms


def plan_for(X: torch.Tensor, B: int, wide_p: int | None = None
             ) -> LaunchPlan:
    """:func:`launch_plan` for a CUDA X and a launch of B queries; with
    ``wide_p``, :func:`retest_plan` for a float32 gather of X's columns."""
    n, p = X.shape
    aligned = X.data_ptr() % 16 == 0
    if wide_p is not None:
        return retest_plan(n, p, wide_p, B, sms_of(X), aligned)
    return launch_plan(n, p, B, sms_of(X), aligned,
                       elem=X.element_size())

_VP, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PLAN = [_INT] * 4   # LaunchPlan.c_args: vec, tile, split, stage_rows
_SIGNATURES = {
    "edpp_screen_scores_f32": [_VP, _VP, _INT, _INT, _INT, *_PLAN, _VP, _F32,
                               _VP, _VP, _VP],
    "screen_matvec_f32": [_VP, _VP, _INT, _INT, _INT, *_PLAN, _VP, _VP],
    "screen_matvec_bf16": [_VP, _VP, _INT, _INT, _INT, *_PLAN, _VP, _VP],
    "fista_step_f32": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, *_PLAN, _VP,
                       _F32, _F32, _F32, _VP, _VP, _VP],
    "fista_step_bf16": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, *_PLAN, _VP,
                        _F32, _F32, _F32, _VP, _VP, _VP],
    "cd_gram_sweep_f32": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP, _F32,
                          _VP, _VP],
    "cd_chain_f32": [_INT, _INT, _F32, _F32, _VP, _VP],
    "group_screen_scores_f32": [_VP, _VP, _INT, _INT, _INT, *_PLAN, _VP,
                                _VP],
    "prox_step_f32": [_VP, _VP, _INT, _VP, _INT, _INT, _VP, _F32, _F32, _F32,
                      _VP, _VP, _VP],
}


def kernel_fn(source: str, symbol: str):
    """The C entry point ``symbol`` of ``csrc/<source>.cu`` with its
    ctypes signature declared (pointers and the stream as c_void_p)."""
    fn = getattr(build.load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[symbol]
        fn.restype = ctypes.c_int
    return fn


def check_x(X: torch.Tensor, op: str, what: str = "X",
            dtypes: tuple = (torch.float32,)) -> None:
    """Raise on an X (or G) the CUDA kernels do not take."""
    if X.device.type != "cuda":
        raise ValueError(f"{op}: {what} must be a CPU or CUDA tensor, "
                         f"got device {X.device}")
    if X.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{op}: the CUDA kernel takes {names} {what}, got "
                        f"{X.dtype} (float64 runs on CPU tensors only)")
    if X.dim() != 2 or not X.is_contiguous():
        raise ValueError(f"{op}: {what} must be a contiguous 2-D matrix, "
                         f"got shape {tuple(X.shape)}")


def check_rows(X: torch.Tensor, v: torch.Tensor, width: int, what: str,
               op: str) -> tuple[torch.Tensor, bool]:
    """Validate a query operand of shape (width,) or (B, width) against
    X's device; return it as (B, width) and whether it was rank 1."""
    if v.device != X.device:
        raise ValueError(f"{op}: {what} is on {v.device}, X on {X.device}")
    if v.dtype != torch.float32:
        raise TypeError(f"{op}: {what} must be float32, got {v.dtype}")
    if v.dim() not in (1, 2) or v.shape[-1] != width:
        raise ValueError(f"{op}: {what} must be ({width},) or (B, {width}), "
                         f"got {tuple(v.shape)}")
    if not v.is_contiguous():
        raise ValueError(f"{op}: {what} must be contiguous")
    if v.dim() == 1:
        return v.unsqueeze(0), True
    return v, False


def params(batch: int, device, *vals):
    """Per-query parameters for a launch: ``(None, floats)`` when every
    value is a host number (passed by value, no copy), else a (k, B)
    float32 device array. Host numbers among device tensors are filled on
    the device (``torch.full``), never copied from the host, so building
    the array costs no sync."""
    if not any(isinstance(v, torch.Tensor) for v in vals):
        return None, tuple(float(v) for v in vals)
    rows = [v.to(device=device, dtype=torch.float32).broadcast_to((batch,))
            if isinstance(v, torch.Tensor) else
            torch.full((batch,), float(v), dtype=torch.float32, device=device)
            for v in vals]
    return torch.stack(rows), (0.0,) * len(vals)


def chunk_ptr(par, b0: int, nb: int):
    """Device pointer to the (k, nb) parameter slice of queries b0..b0+nb;
    the slice stays alive in the stream's allocator order."""
    if par is None:
        return None, None
    sl = par[:, b0:b0 + nb].contiguous()
    return sl, sl.data_ptr()


def check_error(err: int, op: str) -> None:
    if err != 0:
        raise RuntimeError(f"{op}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")


def edpp_screen_scores(X: torch.Tensor, centre: torch.Tensor, rho, *,
                       plan: LaunchPlan | None = None,
                       wide_p: int | None = None):
    """Fused ``(scores, sumsq)``; see the module doc. ``rho`` is a host
    number, a device scalar or a (B,) tensor. ``wide_p``: X is a block of
    the columns of an X with ``wide_p`` columns (a dictionary update's
    added block), and each column is summed as that X's pass sums it
    (:func:`retest_plan`). ``plan`` replaces either choice on a CUDA X
    (for measurements)."""
    if X.device.type == "cpu":
        return ref.edpp_screen_ref(X, centre, rho, wide_p=wide_p)
    op = "edpp_screen_scores"
    check_x(X, op)
    n, p = X.shape
    C, squeeze = check_rows(X, centre, n, "centre", op)
    B = C.shape[0]
    par, (rho_s,) = params(B, X.device, rho)
    fn = (None if cost.is_fake(X)
          else kernel_fn("edpp_screen", "edpp_screen_scores_f32"))
    scores = torch.empty((B, p), dtype=torch.float32, device=X.device)
    sumsq = torch.empty((p,), dtype=torch.float32, device=X.device)
    if p and fn is None:
        for b0 in range(0, B, MAX_B):
            cost.charge(op, cost.column_pass(op, n, p, min(MAX_B, B - b0)))
    elif p:
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream().cuda_stream
            for b0 in range(0, B, MAX_B):
                nb = min(MAX_B, B - b0)
                _keep, ptr = chunk_ptr(par, b0, nb)
                pl = plan or plan_for(X, nb, wide_p)
                check_error(fn(X.data_ptr(), C[b0].data_ptr(), n, p, nb,
                               *pl.c_args, ptr, rho_s,
                               scores[b0].data_ptr(), sumsq.data_ptr(),
                               stream), op)
                LAUNCHES[op] += 1
    return (scores[0] if squeeze else scores), sumsq


def screen_matvec(X: torch.Tensor, centre: torch.Tensor, *,
                  plan: LaunchPlan | None = None,
                  wide_p: int | None = None) -> torch.Tensor:
    """``dot = centre · X``: (p,) for a (n,) centre, (B, p) for (B, n); X
    float32 or its bf16 screen copy, the dots float32. ``wide_p``: X is
    a float32 gather of the columns of an X with ``wide_p`` columns, and
    each dot is summed as that X's pass sums it (:func:`retest_plan`).
    ``plan`` replaces either choice on a CUDA X."""
    if X.device.type == "cpu":
        return ref.screen_matvec_ref(X, centre, wide_p=wide_p)
    op = "screen_matvec"
    check_x(X, op, dtypes=(torch.float32, torch.bfloat16))
    bf16 = X.dtype == torch.bfloat16
    if bf16 and wide_p is not None:
        raise ValueError(f"{op}: wide_p orders a float32 re-test; X is "
                         f"bfloat16")
    n, p = X.shape
    C, squeeze = check_rows(X, centre, n, "centre", op)
    B = C.shape[0]
    symbol = "screen_matvec_bf16" if bf16 else "screen_matvec_f32"
    fn = None if cost.is_fake(X) else kernel_fn("edpp_screen", symbol)
    key = "screen_matvec_bf16" if bf16 else op
    dot = torch.empty((B, p), dtype=torch.float32, device=X.device)
    if p and fn is None:
        for b0 in range(0, B, MAX_B):
            cost.charge(key, cost.column_pass(op, n, p, min(MAX_B, B - b0),
                                              X.element_size()))
    elif p:
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream().cuda_stream
            for b0 in range(0, B, MAX_B):
                nb = min(MAX_B, B - b0)
                pl = plan or plan_for(X, nb, wide_p)
                check_error(fn(X.data_ptr(), C[b0].data_ptr(), n, p, nb,
                               *pl.c_args, dot[b0].data_ptr(), stream), op)
                LAUNCHES[key] += 1
    return dot[0] if squeeze else dot
