"""Backend registry the screening and solver engines dispatch through.

A :class:`ScreenBackend` bundles the five ops of the ported paths:

    matvec(X, centre)                          -> dot = centre·X
    fused_scores(X, centre, rho)               -> (|dot| + ρ‖x_j‖, ‖x_j‖²)
    fista_step(X, r, z, beta_old, step, lam, mom) -> (β', z')
    group_scores(X, centre, m)                 -> ‖X_gᵀ·centre‖ per group
    cd_gram_sweep(G, c, beta, lam, sweeps, valid) -> β after the sweeps

Backends: ``cuda`` (the hand-written kernels of :mod:`.edpp_screen`,
:mod:`.solver_step` and :mod:`.group_screen`; their wrappers take the
plain versions for CPU tensors) and ``torch`` (the plain versions of
:mod:`.ref`). Every backend carries all five ops. With no explicit
choice the backend follows the tensor's device: ``cuda`` for CUDA
tensors, ``torch`` for CPU tensors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import edpp_screen, group_screen, ref, solver_step
from .solver_step import GRAM_BUCKET_MAX  # noqa: F401

OPS = ("edpp_screen_scores", "screen_matvec", "fista_step",
       "group_screen_scores", "cd_gram_sweep")


class ScreenBackend(NamedTuple):
    name: str
    matvec: Callable
    fused_scores: Callable
    fista_step: Callable
    group_scores: Callable
    cd_gram_sweep: Callable


BACKENDS: dict[str, ScreenBackend] = {
    "cuda": ScreenBackend("cuda", edpp_screen.screen_matvec,
                          edpp_screen.edpp_screen_scores,
                          solver_step.fista_step,
                          group_screen.group_screen_scores,
                          solver_step.cd_gram_sweep),
    "torch": ScreenBackend("torch", ref.screen_matvec_ref,
                           ref.edpp_screen_ref, ref.fista_step_ref,
                           ref.group_screen_ref, ref.cd_gram_sweep_ref),
}


def default_backend_name(device: torch.device | str) -> str:
    """``cuda`` on a CUDA device, ``torch`` on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def resolve_backend(name: str | ScreenBackend | None,
                    device: torch.device | str) -> ScreenBackend:
    if isinstance(name, ScreenBackend):
        return name
    name = name or default_backend_name(device)
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; available: "
                         f"{tuple(BACKENDS)}") from None


_LAUNCH_COUNTERS = (edpp_screen.LAUNCHES, solver_step.LAUNCHES,
                    group_screen.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Kernel launches per op since the last :func:`reset_counts`."""
    counts = dict.fromkeys(OPS, 0)
    for c in _LAUNCH_COUNTERS:
        counts.update(c)
    return counts


def plain_counts() -> dict[str, int]:
    """Calls of the plain versions per op since the last reset."""
    counts = dict.fromkeys(OPS, 0)
    counts.update(ref.PLAIN_CALLS)
    return counts


def reset_counts() -> None:
    for c in _LAUNCH_COUNTERS:
        c.clear()
    ref.PLAIN_CALLS.clear()
