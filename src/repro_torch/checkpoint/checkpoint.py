"""Step checkpoints, in the reference's on-disk format
(``src/repro/checkpoint/checkpoint.py``):

    ckpt_dir/step_000123/
        manifest.json     (step, treedef, leaf dtypes and shapes, extra)
        arrays.npz        (leaf_0, leaf_1, ... as full host arrays)
        _DONE             (commit marker: a step without it is ignored)

A step is written under ``step_XXXXXXXX.tmp`` and made visible by one
``os.replace``; the newest ``keep`` committed steps are kept. Leaves are
numbered as the reference's ``jax.tree.flatten`` numbers them (dict keys
in sorted order, NamedTuple fields in order, ``None`` holds no leaf), so a checkpoint written by
either package restores in the other with the same leaves. The manifest's
``treedef`` is informational: :func:`restore` takes the structure from
``like_tree``.

A bfloat16 leaf is written as the reference writes one: numpy has no
bfloat16 without ``ml_dtypes`` (which the port does not use), so the
leaf's 16-bit patterns go in as a 2-byte void array (``|V2``, what
``np.savez`` makes of a jax bfloat16 array) and the manifest's ``dtypes``
entry reads ``"bfloat16"``; :func:`restore` turns such a leaf back into a
``torch.bfloat16`` tensor with the same bits.

**Sharded states** (one process per rank, :mod:`repro_torch.pshard`):
``save(..., shardings=)`` gathers every leaf from the ranks holding it,
writes the whole tree once, on rank 0 of the mesh, and waits for the
mesh's ranks; ``restore(..., shardings=)`` keeps each leaf's block of
this rank, as the reference's ``restore`` places the whole array under
its ``NamedSharding``. A checkpoint is the whole state whatever mesh
wrote it, so it restores on any mesh, and on one device.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.utils._pytree as pytree

from .. import pshard
from ..core.device import resolve_device


def _canonical(tree):
    """``tree`` with every plain dict's keys in sorted order, the order in
    which ``jax.tree.flatten`` visits them, inside lists, tuples and
    NamedTuples too (a train state's params and moments are dicts under
    NamedTuples, whose fields keep their order)."""
    if type(tree) is dict:
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(_canonical(x) for x in tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_canonical(x) for x in tree))
    return tree


def _flatten(tree):
    """(leaves without the Nones, every leaf slot, the spec)."""
    slots, spec = pytree.tree_flatten(_canonical(tree))
    return [x for x in slots if x is not None], slots, spec


def _host(x) -> tuple[np.ndarray, str]:
    """A leaf as the host array :func:`save` writes, and its manifest
    dtype."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view("V2"), "bfloat16"
        x = x.numpy()
    x = np.asarray(x)
    return x, str(x.dtype)


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A saved leaf as a CPU tensor: a ``V2`` leaf recorded as bfloat16
    holds bfloat16 bits."""
    if dtype == "bfloat16" and a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _layouts(shardings, n: int) -> list:
    """The :class:`~repro_torch.pshard.Layout` of each of ``n`` leaves."""
    lays = [x for x in pytree.tree_flatten(_canonical(shardings))[0]
            if x is not None]
    if len(lays) != n:
        raise ValueError(f"shardings has {len(lays)} leaves, the tree {n}")
    return lays


def _gathered(leaves: list, layouts: list) -> list:
    """Every rank's blocks → the whole leaves (collective: every rank of
    the mesh calls it)."""
    from ..core.distributed import mesh_device
    out = []
    for x, lay in zip(leaves, layouts):
        if lay.axes:
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(x))
            x = pshard.gather(t.to(mesh_device(lay.mesh)), lay).cpu()
        out.append(x)
    return out


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None,
         keep: int = 3, *, shardings=None) -> str:
    """Atomically save a tree of tensors and arrays. Returns the step
    directory. ``shardings``: a tree of :class:`~repro_torch.pshard.
    Layout` matching ``tree``, whose leaves are then this rank's blocks:
    every rank of the mesh calls, the whole leaves are written by rank 0
    of the mesh alone, and every rank returns once they are."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    leaves, _, spec = _flatten(tree)
    if shardings is not None:
        layouts = _layouts(shardings, len(leaves))
        leaves = _gathered(leaves, layouts)
        mesh = layouts[0].mesh
        try:
            if not any(pshard.coordinate(mesh).values()):     # rank 0
                _write(ckpt_dir, step_dir, step, leaves, spec, extra, keep)
        finally:
            pshard.barrier(mesh)
        return step_dir
    return _write(ckpt_dir, step_dir, step, leaves, spec, extra, keep)


def _write(ckpt_dir: str, step_dir: str, step: int, leaves: list, spec,
           extra: dict | None, keep: int) -> str:
    tmp = step_dir + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    host_leaves, dtypes = zip(*map(_host, leaves)) if leaves else ((), ())
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": v for i, v in enumerate(host_leaves)})
    manifest = {
        "step": step,
        "treedef": str(spec),
        "n_leaves": len(leaves),
        "dtypes": list(dtypes),
        "shapes": [list(v.shape) for v in host_leaves],
        "extra": extra or {},
        "format": 1,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "_DONE"), "w") as f:
        f.write("ok")
    os.replace(tmp, step_dir)            # atomic commit
    _gc(ckpt_dir, keep)
    return step_dir


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and os.path.exists(os.path.join(ckpt_dir, d, "_DONE")))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> int | None:
    """The newest committed step, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")
             and os.path.exists(os.path.join(ckpt_dir, d, "_DONE"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like_tree, *, device=None,
            shardings=None):
    """Restore into the structure of ``like_tree``, every leaf a tensor
    (of its saved dtype) on ``device`` (None: the card). Returns
    ``(tree, extra)``. ``shardings``: a tree of :class:`~repro_torch.
    pshard.Layout` matching ``like_tree``; each leaf is then this rank's
    block of the saved leaf."""
    dev = resolve_device(device)
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(step_dir, "_DONE")):
        raise FileNotFoundError(f"no committed checkpoint at {step_dir}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        saved = [data[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
    leaves, slots, spec = _flatten(like_tree)
    if len(leaves) != len(saved):
        raise ValueError(f"like_tree has {len(leaves)} leaves, the "
                         f"checkpoint {len(saved)}")
    held = [_tensor(a, dt) for a, dt in zip(saved, manifest["dtypes"])]
    if shardings is not None:
        held = [pshard.cut(t, lay) for t, lay in
                zip(held, _layouts(shardings, len(held)))]
    it = iter(t.to(dev) for t in held)
    tree = pytree.tree_unflatten(
        [None if x is None else next(it) for x in slots], spec)
    return tree, manifest["extra"]
