"""Backend registry the screening and solver engines dispatch through.

A :class:`ScreenBackend` bundles the three ops of the main path:

    matvec(X, centre)                          -> dot = centre·X
    fused_scores(X, centre, rho)               -> (|dot| + ρ‖x_j‖, ‖x_j‖²)
    fista_step(X, r, z, beta_old, step, lam, mom) -> (β', z')

Backends: ``cuda`` (the hand-written kernels of :mod:`.edpp_screen` and
:mod:`.solver_step`; their wrappers take the plain versions for CPU
tensors) and ``torch`` (the plain versions of :mod:`.ref`). Every backend
carries all three ops. With no explicit choice the backend follows the
tensor's device: ``cuda`` for CUDA tensors, ``torch`` for CPU tensors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import edpp_screen, ref, solver_step


class ScreenBackend(NamedTuple):
    name: str
    matvec: Callable
    fused_scores: Callable
    fista_step: Callable


BACKENDS: dict[str, ScreenBackend] = {
    "cuda": ScreenBackend("cuda", edpp_screen.screen_matvec,
                          edpp_screen.edpp_screen_scores,
                          solver_step.fista_step),
    "torch": ScreenBackend("torch", ref.screen_matvec_ref,
                           ref.edpp_screen_ref, ref.fista_step_ref),
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


def launch_counts() -> dict[str, int]:
    """Kernel launches per op since the last :func:`reset_counts`."""
    counts = {"edpp_screen_scores": 0, "screen_matvec": 0, "fista_step": 0}
    counts.update(edpp_screen.LAUNCHES)
    counts.update(solver_step.LAUNCHES)
    return counts


def plain_counts() -> dict[str, int]:
    """Calls of the plain versions per op since the last reset."""
    counts = {"edpp_screen_scores": 0, "screen_matvec": 0, "fista_step": 0}
    counts.update(ref.PLAIN_CALLS)
    return counts


def reset_counts() -> None:
    edpp_screen.LAUNCHES.clear()
    solver_step.LAUNCHES.clear()
    ref.PLAIN_CALLS.clear()
