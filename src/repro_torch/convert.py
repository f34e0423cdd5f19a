"""Carry a fitted dictionary over from the reference into the port.

``session_from_arrays`` takes the reference session's state as numpy
arrays, as a caller reads it from a ``repro.LassoSession``::

    arrays = {"X": np.asarray(sess.geometry.X),
              "sumsq": np.asarray(sess.geometry.sumsq),
              "eig_cache": {b: np.asarray(v)
                            for b, v in sess._eig_cache.items()}}
    port = session_from_arrays(arrays, device="cpu")

and returns a port session that adopts that geometry without a fit pass
(``fit_passes == 0``). A reference *group* session (``groups=m``) hands
over ``{"X": ..., "groups": m, "spec_norms": np.asarray(
sess.geometry.spec_norms)}`` instead of ``sumsq``. Carrying the
per-bucket Lipschitz eigenvectors makes both packages' warm starts begin
from the same vectors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import pshard
from .core.engine import DictionaryGeometry, GroupDictionaryGeometry
from .core.device import as_tensor, resolve_device
from .core.session import LassoSession, PathConfig


def session_from_arrays(arrays, *, config: PathConfig | None = None,
                        device=None) -> LassoSession:
    """A :class:`LassoSession` over ``arrays["X"]`` with the fitted
    ``arrays["sumsq"]`` (‖x_j‖²) — or, for a group session
    (``arrays["groups"] = m``, see ``LassoSession.fit``), the fitted
    ``arrays["spec_norms"]`` (‖X_g‖₂) — and, optionally,
    ``arrays["eig_cache"]`` (bucket size → eigenvector). ``device=None``
    is the card."""
    cfg = config if config is not None else PathConfig()
    dev = resolve_device(device)
    X = as_tensor(arrays["X"], dev)
    if X.dim() != 2:
        raise ValueError(f"X must be (n, p), got shape {tuple(X.shape)}")
    sess = LassoSession._new(X, cfg, arrays.get("groups") or None)
    m = sess.groups
    name, width = ("spec_norms", X.shape[1] // m) if sess.grouped \
        else ("sumsq", X.shape[1])
    fitted = as_tensor(arrays[name], dev, X.dtype)
    if tuple(fitted.shape) != (width,):
        raise ValueError(f"{name} must be ({width},), got "
                         f"{tuple(fitted.shape)}")
    if sess.grouped:
        geom = GroupDictionaryGeometry(X, m, sess._default_backend,
                                       _spec_norms=fitted)
    else:
        geom = DictionaryGeometry(X, sess._default_backend, _sumsq=fitted)
    sess._geometries[geom.backend.name] = geom
    for bucket, v in (arrays.get("eig_cache") or {}).items():
        sess._eig_cache[int(bucket)] = as_tensor(v, dev, X.dtype)
    return sess


# ---------------------------------------------------------------------------
# The LM stack: the reference's parameter tree ↔ the port's modules
# ---------------------------------------------------------------------------
#
# The reference keeps a segment's layers stacked on a leading ``repeat``
# axis (``params["segments"][si]["b{bi}"][...]`` of shape (repeat, ...));
# the port keeps one module per layer, named
# ``segments.{si}.{layer}.b{bi}.{...}``. Every other leaf (``embed``,
# ``lm_head``, ``frame_proj``, ``patch_proj``, ``final_norm.scale``,
# ``shared.{...}``) maps name to path one to one.

def _np(x):
    """A host copy: a CPU tensor's ``numpy()`` would share its memory,
    which the train step updates in place. numpy has no bfloat16, so a
    bf16 tensor's host copy stays a CPU tensor (``checkpoint.save``
    writes it as the reference writes a bfloat16 leaf)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.to("cpu", copy=True)
        return x.numpy().copy() if x.device.type == "cpu" else \
            x.cpu().numpy()
    return np.asarray(x)


def _tensor(x, device) -> torch.Tensor:
    """A fresh tensor on ``device`` (never the caller's own storage: the
    train step updates a model's parameters in place)."""
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    return torch.from_numpy(np.array(x)).to(device)


def _stack(leaves: list):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves)
    if isinstance(leaves[0], pshard.Layout):
        return leaves[0].stacked(len(leaves))
    return np.stack(leaves)


def _to_ref_tree(named: dict, leaf=_np) -> dict:
    """Port names → the reference's nested tree of host arrays (``leaf``
    of each value), each segment's layers stacked on axis 0."""
    tree: dict = {}
    stacks: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "segments":
            si, li = int(parts[1]), int(parts[2])
            stacks.setdefault((si, tuple(parts[3:])), {})[li] = leaf(t)
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf(t)
    if stacks:
        segs = [{} for _ in range(1 + max(si for si, _ in stacks))]
        for (si, path), layers in stacks.items():
            node = segs[si]
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = _stack([layers[i] for i in range(len(layers))])
        tree["segments"] = segs
    return tree


def _from_ref_tree(tree: dict, device) -> dict:
    """The reference's nested tree → {port name: tensor on ``device``},
    each stacked segment leaf unstacked in layer order."""
    out = {}

    def walk(node, prefix, seg):
        for k, v in node.items():
            name = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, name + ".", seg)
            elif seg is None:
                out[name] = _tensor(v, device)
            else:
                for li in range(v.shape[0]):
                    out[f"segments.{seg}.{li}.{name}"] = _tensor(v[li],
                                                                  device)

    walk({k: v for k, v in tree.items() if k != "segments"}, "", None)
    for si, seg_tree in enumerate(tree.get("segments", [])):
        walk(seg_tree, "", si)
    return out


def lm_params_from_reference(params, cfg, *, device=None) -> dict:
    """The reference's LM parameter tree (``init_params``' or a
    ``TrainState``'s ``params``, as numpy arrays, jax arrays or tensors)
    as a state dict for :class:`repro_torch.models.LM` built from
    ``cfg``, on ``device`` (None: the card)."""
    return _from_ref_tree(params, resolve_device(device))


def lm_from_reference(params, cfg, *, device=None):
    """An :class:`repro_torch.models.LM` holding the reference's
    parameters (:func:`lm_params_from_reference`) as f32 masters; leaves
    of any shape (a rank's shards, as ``checkpoint.restore(...,
    shardings=)`` keeps them) give a model holding those."""
    from .models.model import holding
    named = lm_params_from_reference(params, cfg, device=device)
    return holding(cfg, {k: t.float() for k, t in named.items()})


def lm_params_to_reference(model) -> dict:
    """An :class:`repro_torch.models.LM`'s parameters as the reference's
    tree of host arrays (segments stacked)."""
    return _to_ref_tree(dict(model.named_parameters()))


def shardings_to_reference(shardings):
    """A train state's shardings (``init_state``'s tree of
    :class:`~repro_torch.pshard.Layout`) in the reference's layout: the
    tree :func:`train_state_to_reference` gives, each stacked segment
    leaf's layout with its uncut stacking axis (what ``checkpoint.save``
    and ``restore`` take as ``shardings=``)."""
    from .optim.adamw import AdamState
    from .train.steps import TrainState
    opt = shardings.opt

    def tree(named):
        return _to_ref_tree(named, leaf=lambda x: x)

    return TrainState(
        params=tree(shardings.params),
        opt=AdamState(step=opt.step, m=tree(opt.m), v=tree(opt.v),
                      err=None if opt.err is None else tree(opt.err)),
        step=shardings.step)


def train_state_to_reference(state):
    """A port :class:`repro_torch.train.TrainState` in the reference's
    layout: the same NamedTuples with the params, the moments and the
    error buffer as reference trees of host arrays, and the steps as
    int32 arrays. ``checkpoint.save`` numbers its leaves as
    ``jax.tree.flatten`` numbers the reference's state."""
    from .optim.adamw import AdamState
    from .train.steps import TrainState
    opt = state.opt
    return TrainState(
        params=lm_params_to_reference(state.params),
        opt=AdamState(step=_np(opt.step), m=_to_ref_tree(opt.m),
                      v=_to_ref_tree(opt.v),
                      err=None if opt.err is None else _to_ref_tree(opt.err)),
        step=_np(state.step))


def train_state_from_reference(tree, cfg, *, device=None):
    """A port :class:`repro_torch.train.TrainState` from a state in the
    reference's layout (the reference's own ``TrainState`` or
    :func:`train_state_to_reference`'s, arrays or tensors); from a rank's
    shards (``restore(..., shardings=)``), the rank's sharded state."""
    from .optim.adamw import AdamState
    from .train.steps import TrainState
    dev = resolve_device(device)
    opt = tree.opt
    return TrainState(
        params=lm_from_reference(tree.params, cfg, device=dev),
        opt=AdamState(step=_tensor(opt.step, dev).to(torch.int32),
                      m=_from_ref_tree(opt.m, dev),
                      v=_from_ref_tree(opt.v, dev),
                      err=None if opt.err is None
                      else _from_ref_tree(opt.err, dev)),
        step=_tensor(tree.step, dev).to(torch.int32))
