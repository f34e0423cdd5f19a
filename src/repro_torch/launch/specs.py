"""Abstract inputs of every dry-run cell, the reference's
``src/repro/launch/specs.py`` for the port.

The reference builds ``ShapeDtypeStruct``\\ s with ``NamedSharding``\\ s
and lowers one program for the whole mesh. The port runs one process per
rank, so the dry run traces rank 0 of a fake world (:mod:`.dryrun`), and
its inputs are that rank's ``FakeTensor``\\ s: shapes and dtypes on the
card's device or the CPU's, no memory. There is no HLO; the dry run
counts the aten ops the step dispatches on them (:mod:`.hlo_cost`).

* the train state: the rank's shards of the f32 masters and of AdamW's
  moments, cut by :func:`repro_torch.train.steps.shard_state` from a fake
  whole state, with its tree of :class:`~repro_torch.pshard.Layout`\\ s
  (the reference's ``NamedSharding`` tree);
* the batch: the rank's rows, shaped by the ``Layout`` of
  :func:`repro_torch.pshard.batch_spec` (no global host batch);
* decode caches: :func:`repro_torch.models.model.cache_init`'s, the
  rank's blocks (its rows; over "model" an attention cache's kv heads or
  positions, an MLA latent cache's positions, a recurrent state's heads,
  channels or widths: :func:`repro_torch.train.steps.cache_layouts`).

Every function here creates fake tensors and must run inside a
``FakeTensorMode`` (:func:`.hlo_cost.fake_mode`). ``mesh=None`` is one
device: the unsharded step's inputs, no layouts. ``device=None`` is
:func:`.hlo_cost.fake_device`'s default.
"""

from __future__ import annotations

import torch

from .. import configs, pshard
from ..models import model as M
from ..optim import adamw
from ..train import steps as ST


def _device(device) -> torch.device:
    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is None:
        raise RuntimeError("the dry run's inputs are fake tensors: call "
                           "inside `with hlo_cost.fake_mode():`")
    from .hlo_cost import fake_device
    return fake_device(device)


def _rows(mesh, shape: tuple[int, ...]):
    """The rank's block of a batch leaf of global ``shape`` and its
    Layout (None on one device)."""
    if mesh is None:
        return shape, None
    lay = pshard.Layout(pshard.batch_spec(mesh, len(shape), shape[0]),
                        shape, mesh)
    return lay.local_shape, lay


def batch_struct(cfg: M.ArchConfig, shape: configs.ShapeSpec, mesh, *,
                 for_train: bool, device=None):
    """The rank's rows of a batch of ``shape`` ({key: fake tensor}) and
    their Layouts, by frontend: tokens; frames (hubert); tokens and
    image embeddings (vlm); labels when ``for_train``."""
    dev = _device(device)
    b, s = shape.batch, shape.seq
    d = {}
    if cfg.frontend == "tokens":
        d["tokens"] = ((b, s), torch.int32)
    elif cfg.frontend == "frames":
        d["frames"] = ((b, s, cfg.d_frame), torch.float32)
    elif cfg.frontend == "vlm":
        d["tokens"] = ((b, s - cfg.n_img_tokens), torch.int32)
        d["image_embeds"] = ((b, cfg.n_img_tokens, cfg.d_patch),
                             torch.float32)
    if for_train:
        st = s - cfg.n_img_tokens if cfg.frontend == "vlm" else s
        d["labels"] = ((b, st), torch.int32)
    args, shard = {}, {}
    for k, (glob, dt) in d.items():
        local, shard[k] = _rows(mesh, glob)
        args[k] = torch.zeros(local, dtype=dt, device=dev)
    return args, (None if mesh is None else shard)


def _whole_params(cfg: M.ArchConfig, dev) -> dict:
    return {k: torch.empty(p.shape, dtype=p.dtype, device=dev)
            for k, p in M.LM(cfg, device="meta").named_parameters()}


def state_struct(cfg: M.ArchConfig, tc: ST.TrainConfig, mesh,
                 device=None):
    """The rank's train state (f32 master shards, AdamW's moments, steps)
    and its Layout tree (None on one device)."""
    dev = _device(device)
    whole = _whole_params(cfg, dev)
    state = ST.TrainState(params=M.holding(cfg, whole),
                          opt=adamw.init(tc.opt, whole),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=dev))
    if mesh is None:
        return state, None
    return ST.shard_state(state, mesh)


def params_struct(cfg: M.ArchConfig, mesh, device=None):
    """The rank's f32 master shards (an LM holding them) and their
    Layouts (None on one device)."""
    dev = _device(device)
    whole = _whole_params(cfg, dev)
    if mesh is None:
        return M.holding(cfg, whole), None
    layouts = pshard.resolve_tree(mesh, M.param_specs(cfg), whole)
    return M.holding(cfg, {k: pshard.cut(t, layouts[k])
                           for k, t in whole.items()}), layouts


def cache_struct(cfg: M.ArchConfig, batch: int, smax: int, mesh,
                 dtype=torch.bfloat16, device=None):
    """The rank's decode caches (``cache_init``'s, its blocks in
    :func:`repro_torch.train.steps.cache_layouts`: its rows of the batch,
    and over "model" what the reference's cache specs cut) and their
    Layouts (None on one device)."""
    dev = _device(device)
    meta = M.cache_init(cfg, batch, smax, dtype, device="meta")
    lays = None if mesh is None else ST.cache_layouts(cfg, mesh, batch,
                                                      smax)

    def fake(tree, lay):
        if isinstance(tree, dict):
            return {k: fake(v, None if lay is None else lay[k])
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [fake(v, None if lay is None else lay[i])
                    for i, v in enumerate(tree)]
        shape = tree.shape if lay is None else lay.local_shape
        return torch.zeros(shape, dtype=tree.dtype, device=dev)

    return fake(meta, lays), lays


def input_specs(cfg: M.ArchConfig, shape: configs.ShapeSpec, mesh,
                tc: ST.TrainConfig | None = None, device=None):
    """All inputs of one dry-run cell: (kind, args, shardings), args the
    positional arguments of the step :mod:`repro_torch.train.steps`
    makes for the kind. The reference's takes an arch and a shape by
    name; its ``cfg_patch`` served tools this port has not ported."""
    tc = tc or ST.TrainConfig()
    if shape.kind == "train":
        state, sshard = state_struct(cfg, tc, mesh, device)
        batch, bshard = batch_struct(cfg, shape, mesh, for_train=True,
                                     device=device)
        return "train", (state, batch), (sshard, bshard)
    if shape.kind == "prefill":
        params, pshard_ = params_struct(cfg, mesh, device)
        batch, bshard = batch_struct(cfg, shape, mesh, for_train=False,
                                     device=device)
        return "prefill", (params, batch), (pshard_, bshard)
    # decode: one new token into the last slot of a cache of shape.seq
    params, pshard_ = params_struct(cfg, mesh, device)
    caches, cshard = cache_struct(cfg, shape.batch, shape.seq, mesh,
                                  device=device)
    local, tlay = _rows(mesh, (shape.batch, 1))
    tok = torch.zeros(local, dtype=torch.int32, device=_device(device))
    tshard = None if mesh is None else {"tokens": tlay}
    return ("decode", (params, tok, caches, shape.seq - 1),
            (pshard_, cshard, tshard))
