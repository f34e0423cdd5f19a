"""Train / prefill / decode steps of the LM stack, the reference's
``src/repro/train/steps.py``, on one device or sharded over a mesh.

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

Remat is the model's (``ArchConfig.remat``).

**On a mesh** (a ``DeviceMesh`` with axes from ("pod", "data", "model"),
one process per rank, ``torchrun --nproc-per-node N``):

* each rank holds its **shard** of the f32 masters and of AdamW's m, v
  and err, cut by the reference's resolved spec
  (:func:`repro_torch.pshard.resolve_tree` of
  :func:`repro_torch.models.model.param_specs`): ``state.params`` is an
  :class:`~repro_torch.models.LM` holding the shards, and
  :func:`init_state` returns the :class:`~repro_torch.pshard.Layout`
  tree where the reference returns its ``NamedSharding`` tree;
* the step **all-gathers** every leaf cast to the compute dtype (a cast
  then a gather gives the bits of a gather then a cast, in half the
  bytes) and runs forward and backward on the rank's rows of the global
  batch (:func:`repro_torch.data.device_batch`), the loss divided by the
  whole batch's label count;
* it **all-reduces the f32 gradients** (SUM) over the batch axes, then
  takes the bf16 round trip (or, with ``accum_steps > 1``, one reduction
  per microbatch before its bf16 add): the order GSPMD gives the
  reference, whose reduction happens inside ``value_and_grad``;
* every rank then holds the same whole gradient, so the clip and the
  top-k threshold are the one-device code (top-k gathers its err
  buffer), and AdamW updates the rank's shards alone.

The "model" axis shards storage only: no compute is split over it, so a
mesh without a data axis of size > 1 gives the one-device step bit for
bit. MoE routing runs over the whole batch
(:func:`repro_torch.models.layers.moe_route`). Collectives are counted
(:func:`repro_torch.pshard.collective_counts`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import pshard
from ..core.distributed import mesh_device
from ..models import layers as L
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


def _sharded(mesh) -> bool:
    """A ``DeviceMesh`` (the sharded steps); ``None`` or a shape of ones
    is one device."""
    return mesh is not None and hasattr(mesh, "mesh_dim_names")


def check_mesh(mesh) -> None:
    """``None``, a shape of ones, or a ``DeviceMesh`` holding this rank (one
    process per rank). A mesh shape whose size is not the world's raises a
    ``ValueError`` naming ``torchrun``; a ``DeviceMesh`` may cover part of
    the world (an elastic restart on the survivors), but not this rank."""
    if mesh is None:
        return
    if _sharded(mesh):
        if mesh.get_coordinate() is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                             f"{mesh}")
        return
    world = dist.get_world_size() if dist.is_initialized() else 1
    size = int(torch.tensor(tuple(mesh)).prod())
    if size != world:
        raise ValueError(
            f"a mesh of {size} ranks runs one process per rank, and this "
            f"run has {world}: launch with torchrun --nproc-per-node={size}")
    if size > 1:
        raise ValueError(f"a mesh of {size} ranks is a DeviceMesh "
                         f"(repro_torch.launch.mesh.make_mesh), not a shape")


def _replicated(mesh) -> pshard.Layout:
    return pshard.Layout(pshard.P(), (), mesh)


def init_state(key, cfg: M.ArchConfig, tc: TrainConfig, mesh=None, *,
               device=None):
    """A fresh :class:`TrainState` (f32 masters, zero moments, step 0)
    and its shardings: ``None`` on one device, else the state's tree of
    :class:`~repro_torch.pshard.Layout`\\ s (the moments laid out as the
    parameters, the steps replicated). ``key``: an int seed or a
    ``torch.Generator`` on the device; ``device=None`` is the card (on a
    mesh, the mesh's device). A mesh cuts the one-device state: every
    mesh starts from the same bits."""
    check_mesh(mesh)
    if isinstance(key, torch.Generator):
        model = M.LM(cfg, generator=key)
    else:
        model = M.LM(cfg, seed=int(key), device=mesh_device(mesh)
                     if _sharded(mesh) else device)
    opt = adamw.init(tc.opt, dict(model.named_parameters()))
    step = torch.zeros((), dtype=torch.int32, device=model.device)
    state = TrainState(params=model, opt=opt, step=step)
    return shard_state(state, mesh) if _sharded(mesh) else (state, None)


def shard_state(state: TrainState, mesh) -> tuple[TrainState, TrainState]:
    """A whole (one-device) state cut to this rank's shards on ``mesh``,
    and its shardings (see :func:`init_state`)."""
    model = state.params
    layouts = pshard.resolve_tree(mesh, model.specs(),
                                  dict(model.named_parameters()))

    def cut(tree):
        with torch.no_grad():
            return {k: pshard.cut(t, layouts[k]) for k, t in tree.items()}

    opt = state.opt
    sharded = TrainState(
        params=M.holding(model.cfg, cut(dict(model.named_parameters()))),
        opt=adamw.AdamState(step=opt.step.clone(), m=cut(opt.m),
                            v=cut(opt.v),
                            err=None if opt.err is None else cut(opt.err)),
        step=state.step.clone())
    rep = _replicated(mesh)
    return sharded, TrainState(
        params=layouts,
        opt=adamw.AdamState(step=rep, m=layouts, v=layouts,
                            err=None if opt.err is None else layouts),
        step=rep)


def batch_shardings(mesh, cfg: M.ArchConfig, shape_kind: str,
                    batch_example: dict) -> dict:
    """{key: :class:`~repro_torch.pshard.Layout`} of a global batch like
    ``batch_example``: rows over the batch axes, degraded as
    :func:`~repro_torch.pshard.batch_spec` degrades them for its size."""
    return {k: pshard.Layout(pshard.batch_spec(mesh, v.ndim, v.shape[0]),
                             tuple(v.shape), mesh)
            for k, v in batch_example.items()}


def _batch_spec(mesh, batch_shardings_, accum_steps: int = 1) -> pshard.P:
    """Dim 0's spec of the rank's rows: the batch axes, degraded for a
    microbatch of the global batch whose shardings are given (as
    :func:`repro_torch.data.device_batch` cuts it); every batch axis
    without them."""
    if batch_shardings_:
        rows = next(iter(batch_shardings_.values())).shape[0]
        return pshard.batch_spec(mesh, 1, rows // accum_steps)
    return pshard.batch_spec(mesh, 1)


def _gather_params(model: M.LM, layouts: dict, cdt, grad: bool):
    """{name: the whole leaf in the compute dtype}: each shard cast as the
    one-device step casts it (f32 with ndim > 1 to the compute dtype),
    then all-gathered. With ``grad``, also {name: the autograd leaf}: a
    cast leaf's is the gathered values in f32 (exact) and the tree holds
    its cast, so the graph is the one-device step's (master → cast →
    uses) and the gradients come out in its bits and memory layouts."""
    tree, leaves = {}, {}
    for k, p in model.named_parameters():
        cast = p.dtype == F32 and p.dim() > 1 and cdt != F32
        x = pshard.gather(p.detach().to(cdt) if cast else p.detach(),
                          layouts[k])
        if not grad:
            tree[k] = x
            continue
        leaves[k] = (x.to(F32) if cast else x).requires_grad_()
        tree[k] = leaves[k].to(cdt) if cast else leaves[k]
    return (tree, leaves) if grad else tree


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
    hold ``loss``, ``lr`` and ``grad_norm`` as tensors. On a mesh,
    ``state_shardings`` is :func:`init_state`'s and ``batch`` the rank's
    rows (:func:`repro_torch.data.device_batch` with this config's
    ``accum_steps``); the metrics are the whole batch's on every rank."""
    check_mesh(mesh)
    if _sharded(mesh):
        return _sharded_train_step(cfg, tc, mesh, state_shardings,
                                   batch_shardings_)
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


def _sharded_train_step(cfg, tc: TrainConfig, mesh, state_shardings,
                        batch_shardings_):
    """:func:`make_train_step` on a mesh (see the module doc)."""
    cdt = _cdtype(tc)
    gdt = F32 if tc.fp32_grads else torch.bfloat16
    layouts = state_shardings.params
    bspec = _batch_spec(mesh, batch_shardings_, tc.accum_steps)
    baxes = pshard._dim_axes(bspec[0])

    def value_and_grad(model, micro):
        """The whole micro-batch's loss and f32 gradients, reduced."""
        tree, leaves = _gather_params(model, layouts, cdt, grad=True)
        count = pshard.all_reduce(M.label_count(micro), mesh, baxes)
        loss = M.forward_loss(L.tree_from_named(tree), cfg, micro,
                              compute_dtype=cdt, count=count)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        out = {}
        for (k, x), g in zip(leaves.items(), grads):
            if g is None:
                g = torch.zeros_like(x)
            out[k] = pshard.all_reduce(g, mesh, baxes)
        return pshard.all_reduce(loss.detach(), mesh, baxes), out

    def step(state: TrainState, batch: dict):
        model = state.params
        with pshard.batch_context(mesh, bspec):
            if tc.accum_steps > 1:
                loss_sum = torch.zeros((), dtype=F32, device=model.device)
                acc = {k: torch.zeros(lay.shape, dtype=gdt,
                                      device=model.device)
                       for k, lay in layouts.items()}
                for i in range(tc.accum_steps):
                    micro = {k: v.reshape(tc.accum_steps, -1,
                                          *v.shape[1:])[i]
                             for k, v in batch.items()}
                    loss, grads = value_and_grad(model, micro)
                    loss_sum = loss_sum + loss
                    acc = {k: acc[k] + grads[k].to(gdt) for k in acc}
                    del grads
                loss = loss_sum / tc.accum_steps
                grads = {k: g.to(F32) / tc.accum_steps
                         for k, g in acc.items()}
            else:
                loss, grads = value_and_grad(model, batch)
                if not tc.fp32_grads:
                    grads = {k: g.to(torch.bfloat16).to(F32)
                             for k, g in grads.items()}
        err = state.opt.err
        if err is not None:                  # top-k reads whole leaves
            err = {k: pshard.gather(e, layouts[k]) for k, e in err.items()}
        grads, err, gnorm = adamw.transform(tc.opt, grads, err)
        index = {k: lay.index() for k, lay in layouts.items()}
        grads = {k: g[index[k]] for k, g in grads.items()}
        if err is not None:
            err = {k: e[index[k]].contiguous() for k, e in err.items()}
        _, new_opt, om = adamw.apply(tc.opt, state.opt,
                                     dict(model.named_parameters()), grads,
                                     err, gnorm, inplace=True)
        return (TrainState(model, new_opt, state.step + 1),
                {"loss": loss, **om})

    return step


def make_prefill_step(cfg: M.ArchConfig, tc: TrainConfig, mesh=None,
                      param_shardings=None, batch_shardings_=None):
    """``step(model, batch) → (last-token logits, caches)`` on the tree
    cast to the compute dtype. On a mesh the parameters are gathered
    (``param_shardings``: :func:`init_state`'s ``.params``) and ``batch``
    and the logits and caches are the rank's rows."""
    check_mesh(mesh)
    cdt = _cdtype(tc)
    if _sharded(mesh):
        bspec = _batch_spec(mesh, batch_shardings_)

        @torch.no_grad()
        def sharded(model: M.LM, batch: dict):
            tree = L.tree_from_named(_gather_params(model, param_shardings,
                                                    cdt, grad=False))
            with pshard.batch_context(mesh, bspec):
                return M.prefill(tree, cfg, batch, compute_dtype=cdt)

        return sharded

    @torch.no_grad()
    def step(model: M.LM, batch: dict):
        return M.prefill(model.tree(cast=cdt), cfg, batch, compute_dtype=cdt)

    return step


def make_decode_step(cfg: M.ArchConfig, tc: TrainConfig, mesh=None,
                     param_shardings=None, cache_shardings=None,
                     batch_sh=None):
    """``step(model, token, caches, cache_len) → (logits, caches)`` on the
    tree cast to the compute dtype (the caches are written in place). On
    a mesh the parameters are gathered each step and the tokens, logits
    and caches are the rank's rows (``batch_sh``: the token's shardings,
    as :func:`batch_shardings` gives them)."""
    check_mesh(mesh)
    cdt = _cdtype(tc)
    if _sharded(mesh):
        bspec = _batch_spec(mesh, batch_sh)

        @torch.no_grad()
        def sharded(model: M.LM, token, caches, cache_len):
            tree = L.tree_from_named(_gather_params(model, param_shardings,
                                                    cdt, grad=False))
            with pshard.batch_context(mesh, bspec):
                return M.decode_step(tree, cfg, token, caches, cache_len,
                                     compute_dtype=cdt)

        return sharded

    @torch.no_grad()
    def step(model: M.LM, token, caches, cache_len):
        return M.decode_step(model.tree(cast=cdt), cfg, token, caches,
                             cache_len, compute_dtype=cdt)

    return step
