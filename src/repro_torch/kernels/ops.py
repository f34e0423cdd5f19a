"""Backend registry the screening and solver engines dispatch through.

A :class:`ScreenBackend` bundles the six ops of the ported paths:

    matvec(X, centre, wide_p=None)             -> dot = centre·X (X f32
                                                  or its bf16 copy)
    fused_scores(X, centre, rho, wide_p=None)  -> (|dot| + ρ‖x_j‖, ‖x_j‖²)
    fista_step(X, r, z, beta_old, step, lam, mom) -> (β', z')
    group_scores(X, centre, m, wide_p=None)    -> ‖X_gᵀ·centre‖ per group
    cd_gram_sweep(G, c, beta, lam, sweeps, valid) -> β after the sweeps
    prox_step(z, g, beta_old, step, lam, mom)  -> (β', z')

``fista_step`` and ``prox_step`` also take ``params=``, a (3, B) block of
step | λ | mom in place of the three (a row of a solver's parameter
table), and ``prox_step`` a (k, …) stack of the gradient's parts as g.
``wide_p`` says that X is a block of the columns of a wider X with
``wide_p`` columns, and sums each column (each group, for
``group_scores``) as that X's pass sums it (a float32 re-test's gather,
a dictionary update's added block, a mesh rank's block of whole
groups).

The mixed-precision screen's margins, :func:`bf16_column_err` and
:func:`bf16_score_margin`, and the mixed-precision solve's handover,
:func:`bf16_gap_budget` and :func:`bf16_certified_stop`, are the
reference's (``repro.kernels.ops``). ``fista_step`` takes the bf16 copy
of a solve bucket as X (its launches counted as ``fista_step_bf16``).

Backends: ``cuda`` (the hand-written kernels of :mod:`.edpp_screen`,
:mod:`.solver_step` and :mod:`.group_screen`; their wrappers take the
plain versions for CPU tensors) and ``torch`` (the plain versions of
:mod:`.ref`). Every backend carries all six ops. With no explicit
choice the backend follows the tensor's device: ``cuda`` for CUDA
tensors, ``torch`` for CPU tensors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import edpp_screen, group_screen, ref, solver_step
from .solver_step import GRAM_BUCKET_MAX  # noqa: F401

OPS = ("edpp_screen_scores", "screen_matvec", "fista_step",
       "group_screen_scores", "cd_gram_sweep", "prox_step")


class ScreenBackend(NamedTuple):
    name: str
    matvec: Callable
    fused_scores: Callable
    fista_step: Callable
    group_scores: Callable
    cd_gram_sweep: Callable
    prox_step: Callable


BACKENDS: dict[str, ScreenBackend] = {
    "cuda": ScreenBackend("cuda", edpp_screen.screen_matvec,
                          edpp_screen.edpp_screen_scores,
                          solver_step.fista_step,
                          group_screen.group_screen_scores,
                          solver_step.cd_gram_sweep, solver_step.prox_step),
    "torch": ScreenBackend("torch", ref.screen_matvec_ref,
                           ref.edpp_screen_ref, ref.fista_step_ref,
                           ref.group_screen_ref, ref.cd_gram_sweep_ref,
                           ref.prox_step_ref),
}


def default_backend_name(device: torch.device | str = "cuda") -> str:
    """``cuda`` on a CUDA device (the default: the card), ``torch`` on the
    CPU. A backend added to ``BACKENDS`` runs only where it is named."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def resolve_backend(name: str | ScreenBackend | None = None,
                    device: torch.device | str = "cuda") -> ScreenBackend:
    """The backend of a name (or itself), else the device's default."""
    if isinstance(name, ScreenBackend):
        return name
    name = name or default_backend_name(device)
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; available: "
                         f"{tuple(BACKENDS)}") from None


# The mixed-precision screen (``screen_dtype="bfloat16"``). X may be
# stored in bf16 while every dot accumulates in float32, so the only
# storage error is the rounding of X itself: with Δx_j = x_j − x̂_j,
# |x̂_jᵀc − x_jᵀc| ≤ ‖Δx_j‖·‖c‖ for any centre c. ‖Δx_j‖ is measured per
# column when the screen copy is made (:func:`bf16_column_err`); on top
# ride the float32 accumulation noise of both the wide and the narrow
# pass (about n·2⁻²⁴ relative, F32_ACC_ROUND) and a 2× safety factor.

BF16_ROUND = 2.0 ** -8         # bf16 unit roundoff (worst case, 8-bit mant.)
F32_ACC_ROUND = 2.0 ** -24     # float32 accumulation unit roundoff
BF16_MARGIN_SAFETY = 2.0


def bf16_column_err(X: torch.Tensor, X_lo: torch.Tensor) -> torch.Tensor:
    """Per-column dot-error bound for screening through the low-precision
    copy ``X_lo``: ``err[j] = ‖x_j − x̂_j‖ + 2·n·u_f32·‖x_j‖`` (the
    measured quantisation residual and the accumulation noise of the wide
    and the narrow pass), float32 (p,). Both norms sum their squares by
    the fixed tree of :func:`.ref.sum_rows` (elementwise additions, on
    any device), so a block of columns gets the whole width's bits: a
    dictionary update bounds only its added block, a mesh rank its own
    columns."""
    Xf = X.to(torch.float32)
    quant = torch.sqrt(ref.column_sumsq(Xf - X_lo.to(torch.float32)))
    col_norms = torch.sqrt(ref.column_sumsq(Xf))
    n = Xf.shape[0]
    return quant + 2.0 * n * F32_ACC_ROUND * col_norms


def bf16_score_margin(col_err: torch.Tensor, centre_norm) -> torch.Tensor:
    """Per-column bound on the error of a linear screen score evaluated
    through the bf16 copy: ``margin[j] = 2·err_j·‖centre‖``. The ρ‖x_j‖
    term of a sphere score is exact (both factors stay full precision),
    so this bounds the whole score. ``centre_norm`` scalar or (B,) →
    margin (p,) or (B, p)."""
    cn = torch.as_tensor(centre_norm, dtype=torch.float32,
                         device=col_err.device)[..., None]
    return BF16_MARGIN_SAFETY * cn * col_err


# The mixed-precision solve (``solve_dtype="bfloat16"``). The FISTA
# iterations (the forward fit and the fused gradient step) and the Gram-CD
# build G̃ = X̃ᵀX̃, c̃ = X̃ᵀy may read the bf16 copy X̃ of the solve bucket;
# every duality-gap certificate reads float32 X, so a stop at the
# tolerance is true convergence. :func:`bf16_gap_budget` bounds the gap
# below which a bf16 gradient cannot certifiably make progress; the bf16
# phase hands over to the float32 polish once the exact gap both sits
# under BF16_SOLVE_SLACK × that budget and has stopped falling by
# BF16_SOLVE_PROGRESS a check.

BF16_SOLVE_SLACK = 2.0
BF16_SOLVE_PROGRESS = 0.7      # a check that does not cut the gap by 30 %
#                                inside the certified band hands over


def bf16_gap_budget(resid_norm, beta_l1, err_max, col_norm_max):
    """The gap a bf16 gradient stream can leave uncorrected at the
    current iterate, with err_j ≤ ``err_max`` (:func:`bf16_column_err`)
    and ‖x_j‖ ≤ ``col_norm_max``: the residual error
    e_r = err_max·‖β‖₁, the gradient error e_d = err_max·‖r‖ +
    col_norm_max·e_r, and ``budget = e_d·‖β‖₁ + e_r·‖r‖``. Scalars or
    (B,) tensors throughout."""
    e_r = err_max * beta_l1
    e_d = err_max * resid_norm + col_norm_max * e_r
    return e_d * beta_l1 + e_r * resid_norm


def bf16_certified_stop(gap, budget, prev_gap, tol_scale):
    """The handover rule of every bf16 solve phase: stop when the exact
    gap is under ``tol_scale`` (converged), or when it has both stalled
    (gap > BF16_SOLVE_PROGRESS·prev_gap) and sits under BF16_SOLVE_SLACK ×
    ``budget``. Scalar or (B,) float32 tensors; the first check passes
    ``prev_gap = inf``. Evaluated in float32, as the reference evaluates
    it on the device, so the same gap and budget give the same
    decision."""
    stalled = gap > BF16_SOLVE_PROGRESS * prev_gap
    floored = gap <= BF16_SOLVE_SLACK * budget
    return (gap <= tol_scale) | (stalled & floored)


_LAUNCH_COUNTERS = (edpp_screen.LAUNCHES, solver_step.LAUNCHES,
                    group_screen.LAUNCHES)
_COUNTER_OF = {"edpp_screen_scores": edpp_screen.LAUNCHES,
               "screen_matvec": edpp_screen.LAUNCHES,
               "screen_matvec_bf16": edpp_screen.LAUNCHES,
               "group_screen_scores": group_screen.LAUNCHES,
               "fista_step": solver_step.LAUNCHES,
               "fista_step_bf16": solver_step.LAUNCHES,
               "cd_gram_sweep": solver_step.LAUNCHES,
               "prox_step": solver_step.LAUNCHES}


def launch_counts() -> dict[str, int]:
    """Kernel launches per op since the last :func:`reset_counts`; the
    bf16 instantiations (``screen_matvec_bf16``, ``fista_step_bf16``)
    are listed once launched."""
    counts = dict.fromkeys(OPS, 0)
    for c in _LAUNCH_COUNTERS:
        counts.update(c)
    return counts


def plain_counts() -> dict[str, int]:
    """Calls of the plain versions per op since the last reset."""
    counts = dict.fromkeys(OPS, 0)
    counts.update(ref.PLAIN_CALLS)
    return counts


def add_counts(launches: dict[str, int], plain: dict[str, int],
               times: int = 1) -> None:
    """Add ``times`` × the given launches and plain-version calls to the
    counts: a CUDA graph's replay runs what its capture recorded
    (``repro_torch.core.graphs``), and a negative ``times`` takes back
    what the capture itself counted, which ran nothing."""
    for op, k in launches.items():
        _COUNTER_OF[op][op] += times * k
    for op, k in plain.items():
        ref.PLAIN_CALLS[op] += times * k


def reset_counts() -> None:
    for c in _LAUNCH_COUNTERS:
        c.clear()
    ref.PLAIN_CALLS.clear()
