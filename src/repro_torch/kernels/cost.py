"""The cost rules of the six hand-written kernels, and their fake launches.

One set of rules, read in two places:

* ``chip_smoke.py`` prints each kernel's bound beside its time: the least
  time an H100 SXM could take for the same work, the larger of the bytes
  the function must move (each input read once, each output written
  once) over the device memory rate and the operations it does over the
  float32 rate outside the tensor cores (:func:`bound_ms`);
* the dry run (:mod:`repro_torch.launch.hlo_cost`) charges the same bytes
  and operations for each launch a traced program makes on a
  ``FakeTensor`` (:func:`charge`).

A kernel wrapper that receives a CUDA ``FakeTensor`` (:func:`is_fake`)
checks its arguments as for a launch, returns fake outputs of the op's
shapes and dtypes and charges one :class:`KernelCost` per launch it
would make, with the launch's own B (a batch over ``MAX_B`` queries is
several launches). It never launches anything and no real tensor
reaches it: this is the op's fake implementation, as
``torch.library.register_fake`` gives a custom op one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

# NVIDIA's H100 SXM data sheet (dense rates, 700 W)
H100_HBM_BYTES_PER_S = 3.35e12      # device memory rate
H100_F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores


class KernelCost(NamedTuple):
    """What one launch must move and compute."""
    bytes: float
    flops: float


def column_pass(op: str, n: int, p: int, B: int,
                x_bytes: int = 4) -> KernelCost:
    """One launch of a column-pass kernel over X (n, p) for B queries;
    X's elements take ``x_bytes`` (2 for a bf16 copy), the rest 4.
    ``screen_matvec`` reads the centres and writes the dots;
    ``edpp_screen_scores`` also writes ‖x_j‖²; ``fista_step`` reads r,
    z and β_old and writes β' and z'."""
    words = {"screen_matvec": B * n + B * p,
             "edpp_screen_scores": B * n + B * p + p,
             "fista_step": B * n + 4 * B * p}[op]
    flops = {"screen_matvec": 2 * B * n * p,
             "edpp_screen_scores": 2 * B * n * p + 2 * n * p + 3 * B * p,
             "fista_step": 2 * B * n * p + 6 * B * p}[op]
    return KernelCost(4.0 * words + x_bytes * n * p, float(flops))


def cd_sweep(p: int, B: int, sweeps: int, masked: bool) -> KernelCost:
    """One launch of the Gram sweep: G, the (B, p) c and β (and ``valid``
    when given) read once, β' written once, the B per-query λ read when
    B > 1 (one λ is passed by value); 2·B·(sweeps + 1)·p² flops (q₀ = βG
    and one rank-1 update of q per coordinate)."""
    vectors = (4 if masked else 3) * B * p + (B if B > 1 else 0)
    return KernelCost(4.0 * (p * p + vectors),
                      2.0 * B * (sweeps + 1) * p * p)


def prox(p: int, B: int, parts: int = 1) -> KernelCost:
    """One launch of the prox step: z, β_old and the ``parts`` gradient
    parts read, β' and z' written, (parts + 4)·B·p·4 bytes; (parts +
    7)·B·p flops (the parts' sums, then 8 per element)."""
    return KernelCost(4.0 * (parts + 4) * B * p, (parts + 7.0) * B * p)


def group_pass(n: int, p: int, m: int) -> KernelCost:
    """One launch of the group pass over X (n, p) in groups of m: X and
    the centre read, p/m scores written; 2 flops per element of X and 2
    per column for the groups' norms."""
    return KernelCost(4.0 * (n * p + n + p // m), 2.0 * n * p + 2.0 * p)


def bound_ms(cost: KernelCost) -> tuple[float, str]:
    """The least time an H100 SXM takes for ``cost`` and what bounds it:
    ("bytes" or "operations")."""
    t_bytes = cost.bytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = cost.flops / H100_F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(op: str, n: int, p: int, B: int,
          x_bytes: int = 4) -> tuple[float, str]:
    return bound_ms(column_pass(op, n, p, B, x_bytes))


def cd_bound(p: int, B: int, sweeps: int,
             masked: bool) -> tuple[float, str]:
    return bound_ms(cd_sweep(p, B, sweeps, masked))


def prox_bound(p: int, B: int, parts: int = 1) -> tuple[float, str]:
    return bound_ms(prox(p, B, parts))


def group_bound(n: int, p: int, m: int) -> tuple[float, str]:
    return bound_ms(group_pass(n, p, m))


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a ``FakeTensor`` (a dry run's tensor: shapes and
    dtypes, no memory)."""
    return isinstance(t, FakeTensor)


# the cost recorders that are active (repro_torch.launch.hlo_cost.CostMode)
RECORDERS: list = []


def charge(op: str, cost: KernelCost) -> None:
    """One fake launch of kernel ``op`` costing ``cost``, told to every
    active recorder."""
    for r in RECORDERS:
        r.charge_kernel(op, cost)
