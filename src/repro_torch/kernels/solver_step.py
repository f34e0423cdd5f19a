"""Solver kernels: the fused FISTA iteration tail, the Gram CD sweep and
the FISTA prox step over p-vectors.

``fista_step(X, r, z, beta_old, step, lam, mom)`` returns
``(β', z')`` with

    g  = Xᵀr                      (r = Xz − y, the caller's forward fit)
    β' = S(z − step·g, step·λ)
    z' = β' + mom·(β' − β_old)

Replaces ``fista_step`` of ``src/repro/kernels/solver_step.py`` (its
``pl.pallas_call`` at line 146). ``r`` is (n,) or (B, n) with ``z``/
``beta_old`` (p,) or (B, p); ``step``/``lam``/``mom`` are host numbers
(passed by value), device scalars or (B,) tensors, so the solver's loop
needs no host sync per iteration. A CPU X takes the plain version of
:mod:`.ref`; a CUDA X launches ``csrc/solver_step.cu`` (float32,
contiguous) or raises.

Bound on an H100: one read of the reduced bucket X (n·b·4 bytes) plus
4·B·b·4 bytes of vectors, 2·B flops per element of X. At the unscreened
width (p = 50 000) that is the bytes of X, and the pass takes the wide
layout of the screens (``edpp_screen.launch_plan``). The solver's
buckets are narrow (32 to a few thousand columns of n = 784 rows) and
stay in L2 across iterations, so there the bound is latency: the launch,
one round trip to L2 and the reductions. For them the plan takes
32-column tiles (8 lanes × float4 per row, 4 rows per warp step) and
splits the rows over the CTAs of a thread-block cluster (4 CTAs of 196
rows at 784 × 32), each staging only its rows of r; a thread issues all
its row loads before its FMAs (and its first ones before r is staged),
each CTA writes its sums into the shared memory of the CTA that owns
those columns, and the prox and momentum epilogue is spread over the
cluster's CTAs, with z and β_old fetched before the pass. The gradient
stays in registers and shared memory; only β' and z' are written.
Measured on an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``,
``PERF.md`` §6): 0.0078 ms at 784 × 32, B = 1, against 0.0130 for the
earlier one-block design; the same launch on zero rows takes 0.0070 ms
and a 1-element ``zero_()`` 0.0050, so the launch and the cluster's
barriers set the time, not the rows.

``cd_gram_sweep(G, c, beta, lam, sweeps, valid)`` runs ``sweeps`` cyclic
coordinate-descent sweeps over the Gram system G = XᵀX, c = Xᵀy
(``ref.cd_gram_sweep_ref`` states the update). Replaces ``cd_gram_sweep``
of ``src/repro/kernels/solver_step.py`` (its ``pl.pallas_call`` at line
251). G is (p, p) with p ≤ ``GRAM_BUCKET_MAX``, the crossover up to
which the ``cd`` strategy solves on the Gram system; ``c``/``beta``/
``valid`` are (p,) or (B, p), ``lam`` a host number, a device scalar or a
(B,) tensor. A CUDA G launches ``csrc/cd_gram.cu``: one block per query,
the coordinates in chunks of 32, one warp a chunk. The owning warp runs
its chunk's steps with G's entries in registers and each step's change
broadcast by a warp shuffle; one block barrier follows each chunk (none
for p ≤ 32, where one warp holds the whole system), after which the other
warps add the chunk's changes to their q in coordinate order. Its time
is the latency of the chain of ``sweeps·p`` dependent steps, not the
bytes of G nor its flops; ``cd_chain_f32`` in the same source runs that
step alone, without loads, so that ``chip_smoke.py`` can time it.

``prox_step(z, g, beta_old, step, lam, mom)`` returns ``(β', z')`` with

    u  = z − step·g
    β' = S(u, step·λ)
    z' = β' + mom·(β' − β_old)

Replaces ``prox_step`` of ``src/repro/kernels/prox_step.py`` (its
``pl.pallas_call`` at line 67). The distributed FISTA's ``"chunked"`` and
``"stale"`` modes (:func:`repro_torch.core.distributed.dist_fista`) call
it on each rank's feature block, after the gradient came together from
the per-chunk collectives. ``z``/``g``/``beta_old`` are (p,) or (B, p);
``step``/``lam``/``mom`` are taken as by ``fista_step``. A CUDA z launches
``csrc/prox_step.cu`` (float32, contiguous) or raises. It reads z, g and
β_old and writes β' and z', 20 bytes per element for 8 flops, so it is
bound by the bytes (1.0 MB at p = 50 000: 0.3 µs at 3.35 TB/s), and at
the distributed solver's widths by the launch itself. One thread per 4
elements, float4 accesses where p % 4 == 0 and the pointers are 16-byte
aligned.
"""

from __future__ import annotations

import collections

import torch

from . import ref
from .edpp_screen import (MAX_B, LaunchPlan, check_error, check_rows, check_x,
                          chunk_ptr, kernel_fn, params, plan_for)

GRAM_BUCKET_MAX = 1024   # largest Gram system (columns) cd_gram_sweep takes
LAUNCHES: collections.Counter = collections.Counter()


def fista_step(X: torch.Tensor, r: torch.Tensor, z: torch.Tensor,
               beta_old: torch.Tensor, step, lam, mom, *,
               plan: LaunchPlan | None = None):
    """One fused FISTA iteration tail; see the module doc. ``plan``
    replaces ``edpp_screen.launch_plan``'s choice on a CUDA X."""
    if X.device.type == "cpu":
        return ref.fista_step_ref(X, r, z, beta_old, step, lam, mom)
    op = "fista_step"
    check_x(X, op)
    n, p = X.shape
    R, squeeze = check_rows(X, r, n, "r", op)
    Z, _ = check_rows(X, z, p, "z", op)
    Bo, _ = check_rows(X, beta_old, p, "beta_old", op)
    B = R.shape[0]
    if Z.shape[0] != B or Bo.shape[0] != B or z.dim() != r.dim():
        raise ValueError(f"{op}: r {tuple(r.shape)}, z {tuple(z.shape)} and "
                         f"beta_old {tuple(beta_old.shape)} disagree on B")
    par, scal = params(B, X.device, step, lam, mom)
    fn = kernel_fn("solver_step", "fista_step_f32")
    beta_new = torch.empty((B, p), dtype=torch.float32, device=X.device)
    z_new = torch.empty((B, p), dtype=torch.float32, device=X.device)
    if p:
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream().cuda_stream
            for b0 in range(0, B, MAX_B):
                nb = min(MAX_B, B - b0)
                _keep, ptr = chunk_ptr(par, b0, nb)
                pl = plan or plan_for(X, nb)
                check_error(fn(X.data_ptr(), R[b0].data_ptr(),
                               Z[b0].data_ptr(), Bo[b0].data_ptr(), n, p,
                               nb, *pl.c_args, ptr, *scal,
                               beta_new[b0].data_ptr(), z_new[b0].data_ptr(),
                               stream), op)
                LAUNCHES[op] += 1
    if squeeze:
        return beta_new[0], z_new[0]
    return beta_new, z_new


def cd_gram_sweep(G: torch.Tensor, c: torch.Tensor, beta: torch.Tensor, lam,
                  sweeps: int = 1, valid: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """``sweeps`` cyclic CD sweeps over the Gram system; see the module
    doc. Returns the new β, shaped like ``beta``."""
    op = "cd_gram_sweep"
    p = G.shape[0]
    if p > GRAM_BUCKET_MAX:
        raise ValueError(f"{op}: p={p} exceeds GRAM_BUCKET_MAX="
                         f"{GRAM_BUCKET_MAX}")
    if G.device.type == "cpu":
        return ref.cd_gram_sweep_ref(G, c, beta, lam, sweeps, valid)
    check_x(G, op, "G")
    if G.shape != (p, p):
        raise ValueError(f"{op}: G must be square, got {tuple(G.shape)}")
    Bt, squeeze = check_rows(G, beta, p, "beta", op)
    C, _ = check_rows(G, c, p, "c", op)
    V = None
    if valid is not None:
        V, _ = check_rows(G, valid, p, "valid", op)
    B = Bt.shape[0]
    if c.dim() != beta.dim() or C.shape[0] != B or (
            V is not None and (valid.dim() != beta.dim() or V.shape[0] != B)):
        raise ValueError(f"{op}: c {tuple(c.shape)}, beta {tuple(beta.shape)}"
                         f" and valid disagree on B")
    sweeps = int(sweeps)
    if sweeps < 0:
        raise ValueError(f"{op}: sweeps must be ≥ 0, got {sweeps}")
    par, (lam_s,) = params(B, G.device, lam)
    fn = kernel_fn("cd_gram", "cd_gram_sweep_f32")
    out = torch.empty((B, p), dtype=torch.float32, device=G.device)
    if p:
        with torch.cuda.device(G.device):
            stream = torch.cuda.current_stream().cuda_stream
            for b0 in range(0, B, MAX_B):
                nb = min(MAX_B, B - b0)
                _keep, ptr = chunk_ptr(par, b0, nb)
                check_error(fn(G.data_ptr(), C[b0].data_ptr(),
                               Bt[b0].data_ptr(),
                               None if V is None else V[b0].data_ptr(), p,
                               nb, sweeps, ptr, lam_s, out[b0].data_ptr(),
                               stream), op)
                LAUNCHES[op] += 1
    return out[0] if squeeze else out


def _check_vec(v: torch.Tensor, what: str, like: torch.Tensor,
               op: str) -> None:
    if v.device != like.device:
        raise ValueError(f"{op}: {what} is on {v.device}, z on {like.device}")
    if v.dtype != torch.float32:
        raise TypeError(f"{op}: the CUDA kernel takes float32 {what}, got "
                        f"{v.dtype} (float64 runs on CPU tensors only)")
    if v.shape != like.shape or v.dim() not in (1, 2):
        raise ValueError(f"{op}: z, g and beta_old must share one (p,) or "
                         f"(B, p) shape, got {what} {tuple(v.shape)} and z "
                         f"{tuple(like.shape)}")
    if not v.is_contiguous():
        raise ValueError(f"{op}: {what} must be contiguous")


def prox_step(z: torch.Tensor, g: torch.Tensor, beta_old: torch.Tensor,
              step, lam, mom):
    """``(β', z')``, shaped like ``z``; see the module doc."""
    if z.device.type == "cpu":
        return ref.prox_step_ref(z, g, beta_old, step, lam, mom)
    op = "prox_step"
    if z.device.type != "cuda":
        raise ValueError(f"{op}: z must be a CPU or CUDA tensor, got device "
                         f"{z.device}")
    for v, what in ((z, "z"), (g, "g"), (beta_old, "beta_old")):
        _check_vec(v, what, z, op)
    B, p = (1, z.shape[0]) if z.dim() == 1 else tuple(z.shape)
    par, scal = params(B, z.device, step, lam, mom)
    fn = kernel_fn("prox_step", "prox_step_f32")
    beta_new = torch.empty_like(z)
    z_new = torch.empty_like(z)
    if B and p:
        with torch.cuda.device(z.device):
            stream = torch.cuda.current_stream().cuda_stream
            check_error(fn(z.data_ptr(), g.data_ptr(), beta_old.data_ptr(), B,
                           p, None if par is None else par.data_ptr(), *scal,
                           beta_new.data_ptr(), z_new.data_ptr(), stream), op)
            LAUNCHES[op] += 1
    return beta_new, z_new
