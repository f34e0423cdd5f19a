"""Screening kernels: the fused EDPP score pass and the screening matvec.

``edpp_screen_scores(X, centre, rho)``
    ``scores[b, j] = |x_jᵀc_b| + ρ_b‖x_j‖`` and ``sumsq[j] = ‖x_j‖²`` in
    one pass over X. Replaces ``edpp_screen_scores`` of
    ``src/repro/kernels/edpp_screen.py`` (its ``pl.pallas_call`` at line
    140). The session runs it once at fit, with a zero centre, for ‖x_j‖².

``screen_matvec(X, centre)``
    ``dot[b, j] = x_jᵀc_b``. Replaces ``screen_matvec`` of the same file
    (``pl.pallas_call`` at line 202); one call attaches each query
    (|Xᵀy|) and one serves every sphere screen on the λ-path.

Both take X (n, p) and a centre (n,) or (B, n). A CPU X takes the plain
versions of :mod:`.ref`. A CUDA X launches the kernels of
``csrc/edpp_screen.cu`` (float32, contiguous, built by :mod:`.build`) or
raises; there is no fallback.

Bound on an H100: the pass reads X once (n·p·4 bytes) and does 2·B
flops per element, so for B ≤ 8 it is bound by the bytes of X at
3.35 TB/s (157 MB at 784 × 50 000: 47 µs). The TPU kernel carried a
(Bp, bp) accumulator across a sequential grid axis over n; on the card a
block owns 32 columns and walks all n rows itself, its warps reading
coalesced 128-byte row segments, the centre slice staged in shared
memory, and the row phases summed in shared memory in a fixed order
(``csrc/colpass.cuh``).

``LAUNCHES`` counts kernel launches per op (one per launch of up to
``MAX_B`` queries; a larger batch is split into several launches).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import build, ref

MAX_B = 8          # queries per launch (colpass::MAX_B); larger B is split
LAUNCHES: collections.Counter = collections.Counter()

_VP, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "edpp_screen_scores_f32": [_VP, _VP, _INT, _INT, _INT, _VP, _F32, _VP,
                               _VP, _VP],
    "screen_matvec_f32": [_VP, _VP, _INT, _INT, _INT, _VP, _VP],
    "fista_step_f32": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP, _F32,
                       _F32, _F32, _VP, _VP, _VP],
    "cd_gram_sweep_f32": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP, _F32,
                          _VP, _VP],
    "group_screen_scores_f32": [_VP, _VP, _INT, _INT, _INT, _VP, _VP],
    "prox_step_f32": [_VP, _VP, _VP, _INT, _INT, _VP, _F32, _F32, _F32, _VP,
                      _VP, _VP],
}


def kernel_fn(source: str, symbol: str):
    """The C entry point ``symbol`` of ``csrc/<source>.cu`` with its
    ctypes signature declared (pointers and the stream as c_void_p)."""
    fn = getattr(build.load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[symbol]
        fn.restype = ctypes.c_int
    return fn


def check_x(X: torch.Tensor, op: str, what: str = "X") -> None:
    """Raise on an X (or G) the CUDA kernels do not take."""
    if X.device.type != "cuda":
        raise ValueError(f"{op}: {what} must be a CPU or CUDA tensor, "
                         f"got device {X.device}")
    if X.dtype != torch.float32:
        raise TypeError(f"{op}: the CUDA kernel takes float32 {what}, got "
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


def edpp_screen_scores(X: torch.Tensor, centre: torch.Tensor, rho):
    """Fused ``(scores, sumsq)``; see the module doc. ``rho`` is a host
    number, a device scalar or a (B,) tensor."""
    if X.device.type == "cpu":
        return ref.edpp_screen_ref(X, centre, rho)
    op = "edpp_screen_scores"
    check_x(X, op)
    n, p = X.shape
    C, squeeze = check_rows(X, centre, n, "centre", op)
    B = C.shape[0]
    par, (rho_s,) = params(B, X.device, rho)
    fn = kernel_fn("edpp_screen", "edpp_screen_scores_f32")
    scores = torch.empty((B, p), dtype=torch.float32, device=X.device)
    sumsq = torch.empty((p,), dtype=torch.float32, device=X.device)
    if p:
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream().cuda_stream
            for b0 in range(0, B, MAX_B):
                nb = min(MAX_B, B - b0)
                _keep, ptr = chunk_ptr(par, b0, nb)
                check_error(fn(X.data_ptr(), C[b0].data_ptr(), n, p, nb, ptr,
                               rho_s, scores[b0].data_ptr(),
                               sumsq.data_ptr(), stream), op)
                LAUNCHES[op] += 1
    return (scores[0] if squeeze else scores), sumsq


def screen_matvec(X: torch.Tensor, centre: torch.Tensor) -> torch.Tensor:
    """``dot = centre · X``: (p,) for a (n,) centre, (B, p) for (B, n)."""
    if X.device.type == "cpu":
        return ref.screen_matvec_ref(X, centre)
    op = "screen_matvec"
    check_x(X, op)
    n, p = X.shape
    C, squeeze = check_rows(X, centre, n, "centre", op)
    B = C.shape[0]
    fn = kernel_fn("edpp_screen", "screen_matvec_f32")
    dot = torch.empty((B, p), dtype=torch.float32, device=X.device)
    if p:
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream().cuda_stream
            for b0 in range(0, B, MAX_B):
                nb = min(MAX_B, B - b0)
                check_error(fn(X.data_ptr(), C[b0].data_ptr(), n, p, nb,
                               dot[b0].data_ptr(), stream), op)
                LAUNCHES[op] += 1
    return dot[0] if squeeze else dot
