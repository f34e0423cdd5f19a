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
* the step **all-gathers** each leaf cast to the compute dtype (a cast
  then a gather gives the bits of a gather then a cast, in half the
  bytes) over the axes that cut it but "model": the reference's FSDP
  gather over "data". A leaf cut over "model" stays the rank's block, and
  the layers compute the rank's part of the attention, MLA, Mamba2 and
  mLSTM heads, the FFN's hidden width, the MoE experts and the
  vocabulary (:mod:`repro_torch.pshard`'s split regions, each block's
  ``SPLIT``). A leaf whose columns concatenate unlike parts (Mamba2's
  ``w_in`` and ``conv_w``, mLSTM's ``w_up`` and ``w_if``) is gathered
  over "model" too and the rank keeps its pieces alone
  (:class:`LeafPlan`). A block whose split is off (its heads do not
  divide "model") or that declares none (``SPLIT = None``: the sLSTM
  recurrence) computes whole, its leaves gathered whole. Forward and
  backward run on the rank's rows of the global batch
  (:func:`repro_torch.data.device_batch`), the loss divided by the whole
  batch's label count;
* it **reduces the f32 gradients** (SUM) over the batch axes, a leaf cut
  over "data" by a reduce-scatter there, so each rank keeps its shard,
  and a leaf replicated over "model" but read inside a split region (the
  kv projections of replicated kv heads, ``qnorm``/``knorm``, MLA's
  ``w_dkv`` and ``kv_norm``, MoE's router, Mamba2's ``a_log``,
  ``dt_bias`` and ``d_skip``, mLSTM's ``f_bias``) also over "model", a
  leaf read as pieces by a reduce-scatter over "model"; then it
  takes the bf16 round trip (or, with ``accum_steps > 1``, one
  reduction per microbatch before its bf16 add): the order
  GSPMD gives the reference, whose reduction happens inside
  ``value_and_grad``;
* the clip's norm reads the shards (:func:`repro_torch.optim.adamw.
  global_norm`), top-k gathers whole leaves and its err buffer, and
  AdamW updates the rank's shards alone.

A mesh whose "model" axis has one rank computes as one device: a mesh
without a data or model axis of size > 1 gives the one-device step bit
for bit. MoE routing runs over the whole batch
(:func:`repro_torch.models.layers.moe_route`). Collectives are counted
(:func:`repro_torch.pshard.collective_counts`, ``collective_tags``).

Prefill and decode gather the leaves alike and compute on the same
split. Every cache takes the reference's layout on "model"
(:func:`cache_layouts`): an attention cache's kv heads cut where 16
divides them, else its sequence; an MLA latent cache's sequence;
Mamba2's ``ssm`` over heads and ``conv`` over channels, mLSTM's ``h``
over d_qk, sLSTM's states over d (a recurrent state is gathered over
"model" where the compute reads it in another layout, and cut again
after the step: :func:`repro_torch.models.model._state_moves`);
:func:`pad_caches` carries prefill's caches into decode's.
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


class LeafPlan(NamedTuple):
    """How the sharded steps treat one leaf: the axes it is gathered over
    (its compute leaf is the rank's block along the others), whether
    its gradient is each model rank's part (a leaf replicated over
    "model" but read inside a split region, or read as pieces), summed
    over "model", and the :class:`~repro_torch.pshard.Pieces` the rank
    reads of it (None: the gathered leaf itself)."""
    gathered: tuple[str, ...]
    partial: bool
    pieces: pshard.Pieces | None = None


def leaf_plans(cfg: M.ArchConfig, layouts: dict) -> dict[str, LeafPlan]:
    """{name: :class:`LeafPlan`} of ``cfg``'s leaves laid out as
    ``layouts``. A leaf is gathered over every axis that cuts it but
    "model". Where "model" has more than one rank, a module declaring
    a :class:`~repro_torch.pshard.Split` splits where the split is
    :meth:`~repro_torch.pshard.Split.on`: the leaves read inside the
    region and replicated over "model" are partial, and a leaf read as
    pieces is gathered over "model" too and partial; where it is off
    (or the module declares ``SPLIT = None``) the module computes whole
    and its own leaves are gathered over every axis."""
    model = M.LM(cfg, device="meta")
    split = pshard.axis_sizes(next(iter(layouts.values())).mesh).get(
        pshard.MODEL_AXIS, 1) > 1
    whole, partial, pieces = set(), set(), {}
    for name, mod in model.named_modules():
        if not split or not hasattr(mod, "SPLIT"):
            continue
        sp = mod.SPLIT
        own = [n for n, _ in mod.named_parameters(recurse=False)]
        if sp is None or not sp.on(layouts[f"{name}.{sp.mark}"]):
            whole.update(f"{name}.{n}" for n in own)
            continue
        pieces.update({f"{name}.{n}": pc
                       for n, pc in (sp.pieces or {}).items()})
        partial.update(
            k for k in (f"{name}.{n}" for n in (own if sp.inside is None
                                                 else sp.inside))
            if k in pieces or pshard.MODEL_AXIS not in layouts[k].axes)
    plans = {}
    for k, lay in layouts.items():
        if k in whole or k in pieces:
            plans[k] = LeafPlan(lay.axes, k in partial, pieces.get(k))
        else:
            plans[k] = LeafPlan(tuple(a for a in lay.axes
                                      if a != pshard.MODEL_AXIS),
                                k in partial)
    return plans


def _model_index(mesh) -> tuple[int, int]:
    """(this rank's index on "model", the axis's size)."""
    return (pshard.coordinate(mesh)[pshard.MODEL_AXIS],
            pshard.axis_sizes(mesh)[pshard.MODEL_AXIS])


def _gather_params(model: M.LM, layouts: dict, plans: dict, cdt,
                   grad: bool):
    """{name: the compute leaf in the compute dtype}: each shard cast as
    the one-device step casts it (f32 with ndim > 1 to the compute
    dtype), then all-gathered over its plan's axes. With ``grad``, also
    {name: the autograd leaf}: a cast leaf's is the gathered values in f32
    (exact) and the tree holds its cast, so the graph is the one-device
    step's (master → cast → uses) and the gradients come out in its bits
    and memory layouts."""
    tree, leaves = {}, {}
    for k, p in model.named_parameters():
        cast = p.dtype == F32 and p.dim() > 1 and cdt != F32
        x = pshard.gather(p.detach().to(cdt) if cast else p.detach(),
                          layouts[k].part(plans[k].gathered), "gather")
        if plans[k].pieces is not None:     # the whole is dropped here
            x = plans[k].pieces.take(x, *_model_index(layouts[k].mesh))
        if not grad:
            tree[k] = x
            continue
        leaves[k] = (x.to(F32) if cast else x).requires_grad_()
        tree[k] = leaves[k].to(cdt) if cast else leaves[k]
    return (tree, leaves) if grad else tree


def _reduce_grad(g: torch.Tensor, lay: pshard.Layout, plan: LeafPlan,
                 baxes: tuple[str, ...]) -> torch.Tensor:
    """The rank's shard of a leaf's gradient, summed over the batch axes
    (and "model" for a partial one), from the gradient of its compute
    leaf (pieces placed back in the gathered leaf's shape first): a dim
    cut over a batch axis, or over "model" for a partial leaf, by a
    reduce-scatter there, a dim cut over another axis by this rank's
    block."""
    mesh = lay.mesh
    if plan.pieces is not None:
        g = plan.pieces.place(g, *_model_index(mesh))
    part = lay.part(plan.gathered)
    scattered = baxes + ((pshard.MODEL_AXIS,) if plan.partial else ())
    own = tuple(a for a in part.axes if a not in scattered)
    if own:
        g = g[part.only(own).index()]
    g = g.contiguous()
    for d in range(g.dim()):
        for a in part.dim_axes(d):
            if a in scattered:
                g = pshard.reduce_scatter(g, mesh, a, d, "grad")
    summed = tuple(a for a in scattered if a not in plan.gathered)
    return pshard.all_reduce(g, mesh, summed, tag="grad")


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
    plans = leaf_plans(cfg, layouts)
    bspec = _batch_spec(mesh, batch_shardings_, tc.accum_steps)
    baxes = pshard._dim_axes(bspec[0])

    def value_and_grad(model, micro):
        """The whole micro-batch's loss and the rank's shards of the f32
        gradients, reduced."""
        tree, leaves = _gather_params(model, layouts, plans, cdt, grad=True)
        count = pshard.all_reduce(M.label_count(micro), mesh, baxes,
                                  tag="loss")
        with pshard.model_context(mesh):
            loss = M.forward_loss(L.tree_from_named(tree), cfg, micro,
                                  compute_dtype=cdt, count=count)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        del tree
        out = {}
        for (k, x), g in zip(leaves.items(), grads):
            if g is None:
                g = torch.zeros_like(x)
            out[k] = _reduce_grad(g, layouts[k], plans[k], baxes)
        return pshard.all_reduce(loss.detach(), mesh, baxes, tag="loss"), out

    def step(state: TrainState, batch: dict):
        model = state.params
        with pshard.batch_context(mesh, bspec):
            if tc.accum_steps > 1:
                loss_sum = torch.zeros((), dtype=F32, device=model.device)
                acc = {k: torch.zeros(lay.local_shape, dtype=gdt,
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
        grads, err, gnorm = adamw.transform(tc.opt, grads, state.opt.err,
                                            layouts)
        _, new_opt, om = adamw.apply(tc.opt, state.opt,
                                     dict(model.named_parameters()), grads,
                                     err, gnorm, inplace=True)
        return (TrainState(model, new_opt, state.step + 1),
                {"loss": loss, **om})

    return step


def cache_layouts(cfg: M.ArchConfig, mesh, batch: int, smax: int):
    """The :class:`~repro_torch.pshard.Layout` tree of
    :func:`repro_torch.models.model.cache_init`'s caches for a global
    batch of ``batch`` rows and ``smax`` positions on ``mesh``, each
    block's as :func:`repro_torch.models.model.block_cache_layouts` lays
    it out (the model's recurrent blocks read the same layouts): an
    attention cache's kv heads or positions, an MLA cache's positions,
    Mamba2's ``ssm`` over heads and ``conv`` over channels, mLSTM's ``h``
    over d_qk and sLSTM's states over d, each over "model" where it
    divides."""
    return [[{f"b{bi}": M.block_cache_layouts(blk, cfg, mesh, batch, smax)
              for bi, blk in enumerate(seg.blocks)}
             for _ in range(seg.repeat)] for seg in cfg.segments]


def pad_caches(cfg: M.ArchConfig, mesh, caches, batch: int, seq: int,
               smax: int):
    """Prefill's caches (``seq`` positions, laid out as
    :func:`cache_layouts` lays them out for ``seq``) zero-padded to
    ``smax`` positions and laid out for ``smax``: (caches, their
    layouts), the caches and ``cache_shardings`` that
    :func:`make_decode_step` continues from at ``cache_len = seq``. On one
    device (``mesh`` None): :func:`repro_torch.models.model.pad_caches`
    and None. An attention or MLA cache whose positions are cut over
    "model" is gathered over it, padded and cut again; a recurrent state
    has no positions, and keeps its layout."""
    if not _sharded(mesh):
        return M.pad_caches(caches, smax), None
    old = cache_layouts(cfg, mesh, batch, seq)
    new = cache_layouts(cfg, mesh, batch, smax)
    model = (pshard.MODEL_AXIS,)

    def seq_cut(c, lays) -> bool:     # positions (axis −2) over "model"
        return set(c) in M._SEQ_CACHES and any(
            pshard.MODEL_AXIS in lay.dim_axes(len(lay.shape) - 2)
            for lay in lays.values())

    def blocks(tree, lays, fn):
        return [[{b: fn(c, lo[b]) if seq_cut(c, lo[b]) else c
                  for b, c in layer.items()}
                 for layer, lo in zip(seg, sl)]
                for seg, sl in zip(tree, lays)]

    whole = blocks(caches, old, lambda c, lays: {
        n: pshard.gather(t, lays[n].part(model), "cache")
        for n, t in c.items()})
    padded = M.pad_caches(whole, smax)
    return blocks(padded, new, lambda c, lays: {
        n: t[lays[n].part(model).index()].contiguous()
        for n, t in c.items()}), new


def make_prefill_step(cfg: M.ArchConfig, tc: TrainConfig, mesh=None,
                      param_shardings=None, batch_shardings_=None):
    """``step(model, batch) → (last-token logits, caches)`` on the tree
    cast to the compute dtype. On a mesh the parameters are gathered as
    the train step gathers them (``param_shardings``: :func:`init_state`'s
    ``.params``), ``batch`` and the logits are the rank's rows (the logits
    over the whole vocabulary), and the caches are the rank's blocks in
    :func:`cache_layouts` for the batch's positions."""
    check_mesh(mesh)
    cdt = _cdtype(tc)
    if _sharded(mesh):
        bspec = _batch_spec(mesh, batch_shardings_)
        plans = leaf_plans(cfg, param_shardings)

        @torch.no_grad()
        def sharded(model: M.LM, batch: dict):
            tree = L.tree_from_named(_gather_params(
                model, param_shardings, plans, cdt, grad=False))
            with pshard.batch_context(mesh, bspec), \
                    pshard.model_context(mesh):
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
    a mesh the parameters are gathered each step, the tokens and logits
    are the rank's rows (``batch_sh``: the token's shardings, as
    :func:`batch_shardings` gives them), and the caches the rank's blocks
    in ``cache_shardings`` (:func:`cache_layouts` or :func:`pad_caches`;
    needed where the "model" axis has more than one rank)."""
    check_mesh(mesh)
    cdt = _cdtype(tc)
    if _sharded(mesh):
        bspec = _batch_spec(mesh, batch_sh)
        plans = leaf_plans(cfg, param_shardings)
        smax = (None if cache_shardings is None
                else M.cache_positions(cache_shardings))
        if smax is None and pshard.axis_sizes(mesh).get(
                pshard.MODEL_AXIS, 1) > 1:
            raise ValueError("decode on a model axis of more than one rank "
                             "takes the caches' layouts: cache_shardings="
                             "steps.cache_layouts(...) or pad_caches(...)'s")

        @torch.no_grad()
        def sharded(model: M.LM, token, caches, cache_len):
            tree = L.tree_from_named(_gather_params(
                model, param_shardings, plans, cdt, grad=False))
            with pshard.batch_context(mesh, bspec), \
                    pshard.model_context(mesh):
                return M.decode_step(tree, cfg, token, caches, cache_len,
                                     compute_dtype=cdt, smax=smax)

        return sharded

    @torch.no_grad()
    def step(model: M.LM, token, caches, cache_len):
        return M.decode_step(model.tree(cast=cdt), cfg, token, caches,
                             cache_len, compute_dtype=cdt)

    return step
