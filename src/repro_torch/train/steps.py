"""Train / prefill / decode steps of the LM stack, the reference's
``src/repro/train/steps.py`` on one device.

``make_train_step`` returns the production step:

    state, metrics = step(state, batch)

* params: f32 masters (the :class:`~repro_torch.models.LM`'s parameters);
  the forward runs on the tree cast to the compute dtype (bf16 by
  default): every f32 parameter with ndim > 1 is cast inside the autograd
  graph, as the reference casts inside its loss (``steps.py:84-87``);
* gradient accumulation over ``accum_steps`` microbatches, their
  gradients summed in bf16 unless ``fp32_grads`` (``:90-113``); on one
  microbatch the gradients take a bf16 round trip unless ``fp32_grads``
  (``:116-119``, the reference's bf16 data-parallel reduction);
* AdamW (:mod:`repro_torch.optim.adamw`) updates the masters and the
  moments in place; the step returns a new :class:`TrainState` holding
  the same model.

Remat is the model's (``ArchConfig.remat``). One device only: the mesh
argument takes ``None`` or a 1×1 mesh; multi-card training (the
reference's logical-axis sharding, ``train/sharding.py`` and
``pshard.py``) is ROADMAP item 14d.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..models import model as M
from ..optim import adamw

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    accum_steps: int = 1
    compute_dtype: str = "bfloat16"
    fp32_grads: bool = False          # True disables bf16 grad compression
    opt: adamw.OptConfig = adamw.OptConfig()


class TrainState(NamedTuple):
    params: M.LM                      # the model: its parameters are the masters
    opt: adamw.AdamState
    step: torch.Tensor                # int32 scalar


def _cdtype(tc: TrainConfig):
    return torch.bfloat16 if tc.compute_dtype == "bfloat16" else F32


def check_mesh(mesh) -> None:
    """``None`` or a one-device mesh (a ``DeviceMesh`` of size 1 or a
    shape of ones); anything wider raises, naming ROADMAP item 14d."""
    if mesh is None:
        return
    size = mesh.size() if hasattr(mesh, "size") else int(
        torch.tensor(tuple(mesh)).prod())
    if size != 1:
        raise NotImplementedError(
            f"multi-device LM training (a mesh of {size} devices) is not "
            f"ported yet (ROADMAP.md item 14d); use one device")


def init_state(key, cfg: M.ArchConfig, tc: TrainConfig, mesh=None, *,
               device=None):
    """A fresh :class:`TrainState` (f32 masters, zero moments, step 0)
    and ``None`` for the reference's shardings. ``key``: an int seed or
    a ``torch.Generator`` on the device; ``device=None`` is the card."""
    check_mesh(mesh)
    if isinstance(key, torch.Generator):
        model = M.LM(cfg, generator=key)
    else:
        model = M.LM(cfg, seed=int(key), device=device)
    opt = adamw.init(tc.opt, dict(model.named_parameters()))
    step = torch.zeros((), dtype=torch.int32, device=model.device)
    return TrainState(params=model, opt=opt, step=step), None


def _value_and_grad(model: M.LM, cfg, cdt, micro: dict):
    params = dict(model.named_parameters())
    loss = M.forward_loss(model.tree(cast=cdt), cfg, micro,
                          compute_dtype=cdt)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    # a parameter the loss never reads (the frames frontend's embed) has
    # the zero gradient, as in the reference
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(params.items(), grads)}


def make_train_step(cfg: M.ArchConfig, tc: TrainConfig, mesh=None,
                    state_shardings=None, batch_shardings_=None):
    """The train step ``step(state, batch) → (state, metrics)``; metrics
    hold ``loss``, ``lr`` and ``grad_norm`` as tensors."""
    check_mesh(mesh)
    cdt = _cdtype(tc)
    gdt = F32 if tc.fp32_grads else torch.bfloat16

    def step(state: TrainState, batch: dict):
        model = state.params
        if tc.accum_steps > 1:
            micros = [{k: v.reshape(tc.accum_steps, -1, *v.shape[1:])[i]
                       for k, v in batch.items()}
                      for i in range(tc.accum_steps)]
            loss_sum = torch.zeros((), dtype=F32, device=model.device)
            acc = {k: torch.zeros(p.shape, dtype=gdt, device=p.device)
                   for k, p in model.named_parameters()}
            for micro in micros:
                loss, grads = _value_and_grad(model, cfg, cdt, micro)
                loss_sum = loss_sum + loss
                acc = {k: acc[k] + grads[k].to(gdt) for k in acc}
                del grads
            loss = loss_sum / tc.accum_steps
            grads = {k: g.to(F32) / tc.accum_steps for k, g in acc.items()}
        else:
            loss, grads = _value_and_grad(model, cfg, cdt, batch)
            if not tc.fp32_grads:
                grads = {k: g.to(torch.bfloat16).to(F32)
                         for k, g in grads.items()}
        _, new_opt, om = adamw.update(tc.opt, state.opt,
                                      dict(model.named_parameters()), grads,
                                      inplace=True)
        return (TrainState(model, new_opt, state.step + 1),
                {"loss": loss, **om})

    return step


def make_prefill_step(cfg: M.ArchConfig, tc: TrainConfig, mesh=None,
                      param_shardings=None, batch_shardings_=None):
    """``step(model, batch) → (last-token logits, caches)`` on the tree
    cast to the compute dtype."""
    check_mesh(mesh)
    cdt = _cdtype(tc)

    @torch.no_grad()
    def step(model: M.LM, batch: dict):
        return M.prefill(model.tree(cast=cdt), cfg, batch, compute_dtype=cdt)

    return step


def make_decode_step(cfg: M.ArchConfig, tc: TrainConfig, mesh=None,
                     param_shardings=None, cache_shardings=None,
                     batch_sh=None):
    """``step(model, token, caches, cache_len) → (logits, caches)`` on the
    tree cast to the compute dtype (the caches are written in place)."""
    check_mesh(mesh)
    cdt = _cdtype(tc)

    @torch.no_grad()
    def step(model: M.LM, token, caches, cache_len):
        return M.decode_step(model.tree(cast=cdt), cfg, token, caches,
                             cache_len, compute_dtype=cdt)

    return step
