"""Step checkpoints, in the reference's on-disk format
(``src/repro/checkpoint/checkpoint.py``):

    ckpt_dir/step_000123/
        manifest.json     (step, treedef, leaf dtypes and shapes, extra)
        arrays.npz        (leaf_0, leaf_1, ... as full host arrays)
        _DONE             (commit marker: a step without it is ignored)

A step is written under ``step_XXXXXXXX.tmp`` and made visible by one
``os.replace``; the newest ``keep`` committed steps are kept. Leaves are
numbered as the reference's ``jax.tree.flatten`` numbers them (dict keys
in sorted order, ``None`` holds no leaf), so a checkpoint written by
either package restores in the other with the same leaves. The manifest's
``treedef`` is informational: :func:`restore` takes the structure from
``like_tree``.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core.device import resolve_device


def _canonical(tree):
    """``tree`` with every plain dict's keys in sorted order, the order in
    which ``jax.tree.flatten`` visits them."""
    if type(tree) is dict:
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(_canonical(x) for x in tree)
    return tree


def _flatten(tree):
    """(leaves without the Nones, every leaf slot, the spec)."""
    slots, spec = pytree.tree_flatten(_canonical(tree))
    return [x for x in slots if x is not None], slots, spec


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None,
         keep: int = 3) -> str:
    """Atomically save a tree of tensors and arrays. Returns the step
    directory."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = step_dir + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    leaves, _, spec = _flatten(tree)
    host_leaves = [_host(x) for x in leaves]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": v for i, v in enumerate(host_leaves)})
    manifest = {
        "step": step,
        "treedef": str(spec),
        "n_leaves": len(leaves),
        "dtypes": [str(v.dtype) for v in host_leaves],
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


def restore(ckpt_dir: str, step: int, like_tree, *, device=None):
    """Restore into the structure of ``like_tree``, every leaf a tensor
    (of its saved dtype) on ``device`` (None: the card). Returns
    ``(tree, extra)``."""
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
    it = iter(torch.from_numpy(np.array(a)).to(dev) for a in saved)
    tree = pytree.tree_unflatten(
        [None if x is None else next(it) for x in slots], spec)
    return tree, manifest["extra"]
