"""Solver kernels: the fused FISTA iteration tail and the Gram CD sweep.

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
4·B·b·4 bytes of vectors, 2·B flops per element of X, so it is bound by
bytes. The solver's buckets are narrow (32 to a few thousand columns of
n = 784 rows): with 32 columns per block that is 1 to ~128 blocks, so the
launch gives each block 32 row phases (1024 threads) where the column
tiles alone would leave most SMs idle (``colpass::row_phases``). The
gradient stays in registers and shared memory; only β' and z' are written.

``cd_gram_sweep(G, c, beta, lam, sweeps, valid)`` runs ``sweeps`` cyclic
coordinate-descent sweeps over the Gram system G = XᵀX, c = Xᵀy
(``ref.cd_gram_sweep_ref`` states the update). Replaces ``cd_gram_sweep``
of ``src/repro/kernels/solver_step.py`` (its ``pl.pallas_call`` at line
251). G is (p, p) with p ≤ ``GRAM_BUCKET_MAX``, the crossover up to
which the ``cd`` strategy solves on the Gram system; ``c``/``beta``/
``valid`` are (p,) or (B, p), ``lam`` a host number, a device scalar or a
(B,) tensor. A CUDA G launches ``csrc/cd_gram.cu`` (one block per query,
one thread per coordinate, G read row by row from L2): its time is the
latency of the chain of ``sweeps·p`` dependent coordinate steps, not the
bytes of G nor its flops.
"""

from __future__ import annotations

import collections

import torch

from . import ref
from .edpp_screen import (MAX_B, check_error, check_rows, check_x, chunk_ptr,
                          kernel_fn, params)

GRAM_BUCKET_MAX = 1024   # largest Gram system (columns) cd_gram_sweep takes
LAUNCHES: collections.Counter = collections.Counter()


def fista_step(X: torch.Tensor, r: torch.Tensor, z: torch.Tensor,
               beta_old: torch.Tensor, step, lam, mom):
    """One fused FISTA iteration tail; see the module doc."""
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
                check_error(fn(X.data_ptr(), R[b0].data_ptr(),
                               Z[b0].data_ptr(), Bo[b0].data_ptr(), n, p,
                               nb, ptr, *scal, beta_new[b0].data_ptr(),
                               z_new[b0].data_ptr(), stream), op)
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
