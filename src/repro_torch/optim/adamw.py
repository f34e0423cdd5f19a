"""AdamW, the LR schedule and the gradient transforms (global-norm clip,
error-feedback top-k), the reference's ``src/repro/optim/adamw.py`` in
PyTorch: its arithmetic in its order, not ``torch.optim.AdamW`` (which
decays the weights before the moment step and rounds otherwise).

Parameters, gradients and moments are dicts of tensors keyed by
parameter name (``dict(model.named_parameters())``). One step is:
clip by the global norm (f32), then top-k compression if on, then
step + 1, then the scheduled lr, then the bias corrections in f32, then
``delta = m̂/(√v̂ + eps) + wd·p`` and ``p − lr·delta``. The moments are
f32 or bf16 (``moment_dtype``; the update runs in f32 and rounds on
store); the error-feedback buffer is bf16.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .. import pshard

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"       # "float32" | "bfloat16"
    topk_compress: float = 0.0          # 0 = off; else keep-fraction


class AdamState(NamedTuple):
    step: torch.Tensor                  # int32 scalar
    m: dict
    v: dict
    err: dict | None                    # error-feedback buffer (compression)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_frac·lr (f32)."""
    step = step.to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(cfg: OptConfig, params: dict) -> AdamState:
    mdt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else F32
    dev = next(iter(params.values())).device

    def zeros(dt):
        return {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                for k, p in params.items()}

    err = zeros(torch.bfloat16) if cfg.topk_compress > 0 else None
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     m=zeros(mdt), v=zeros(mdt), err=err)


def global_norm(tree: dict, layouts: dict | None = None) -> torch.Tensor:
    """‖tree‖₂ in f32. With ``layouts`` ({name: :class:`~repro_torch.
    pshard.Layout`}) the leaves are a rank's shards: each shard's sum of
    squares is summed over the axes that cut its leaf
    (:func:`repro_torch.pshard.sum_shards`), a replicated leaf counted
    once, and the leaves are added in order, as on one device."""
    sq = [torch.sum(torch.square(x.to(F32))) for x in tree.values()]
    if layouts is not None:
        sq = pshard.sum_shards(sq, [layouts[k] for k in tree])
    return torch.sqrt(sum(sq))


def clip_by_global_norm(grads: dict, max_norm: float,
                        layouts: dict | None = None):
    norm = global_norm(grads, layouts)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g.to(F32) * scale for k, g in grads.items()}, norm


def topk_compress(cfg: OptConfig, grads: dict, err: dict):
    """Error-feedback top-k sparsification per leaf: g̃ = topk(g + e),
    e ← (g + e) − g̃, keeping ``cfg.topk_compress`` of the entries by
    magnitude (ties at the threshold kept)."""
    gs, es = {}, {}
    for k, g in grads.items():
        gf = g.to(F32) + err[k].to(F32)
        flat = torch.abs(gf).reshape(-1)
        kk = max(1, int(flat.numel() * cfg.topk_compress))
        thresh = torch.topk(flat, kk).values[-1]
        gsp = torch.where(torch.abs(gf) >= thresh, gf, 0.0)
        gs[k], es[k] = gsp, (gf - gsp).to(torch.bfloat16)
    return gs, es


def transform(cfg: OptConfig, grads: dict, err: dict | None,
              layouts: dict | None = None):
    """The gradient transforms of a step: the global-norm clip, then top-k
    compression if on → (grads, err, the norm). With ``layouts`` the
    gradients and the err buffer are a rank's shards: the clip reads
    shards (:func:`global_norm`), and top-k, which ranks a whole leaf's
    entries, gathers the leaves and keeps the rank's blocks."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, layouts)
    if cfg.topk_compress > 0:
        if layouts is None:
            grads, err = topk_compress(cfg, grads, err)
        else:
            whole = {k: pshard.gather(g, layouts[k], "grad")
                     for k, g in grads.items()}
            werr = {k: pshard.gather(e, layouts[k], "grad")
                    for k, e in err.items()}
            grads, err = topk_compress(cfg, whole, werr)
            index = {k: lay.index() for k, lay in layouts.items()}
            grads = {k: g[index[k]] for k, g in grads.items()}
            err = {k: e[index[k]].contiguous() for k, e in err.items()}
    return grads, err, gnorm


def update(cfg: OptConfig, state: AdamState, params: dict, grads: dict, *,
           inplace: bool = False):
    """One AdamW step → (new params, new state, metrics). ``inplace``
    writes the new values into ``params`` and the moments (under
    ``torch.no_grad``) and returns those dicts: the arithmetic is the
    same, one leaf at a time."""
    grads, err, gnorm = transform(cfg, grads, state.err)
    return apply(cfg, state, params, grads, err, gnorm, inplace=inplace)


def apply(cfg: OptConfig, state: AdamState, params: dict, grads: dict,
          err: dict | None, gnorm: torch.Tensor, *, inplace: bool = False):
    """The moment and parameter update of :func:`update` on transformed
    gradients. Elementwise, so a rank's shards of the parameters, the
    moments and the transformed gradients update those entries of the
    whole leaves."""
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.betas
    bc1 = 1.0 - torch.pow(b1, step.to(F32))
    bc2 = 1.0 - torch.pow(b2, step.to(F32))

    new_p, new_m, new_v = {}, {}, {}
    with torch.no_grad():
        for k, p in params.items():
            g = grads.pop(k).to(F32)
            m, v = state.m[k], state.v[k]
            m_new = b1 * m.to(F32) + (1 - b1) * g
            v_new = b2 * v.to(F32) + (1 - b2) * torch.square(g)
            mhat = m_new / bc1
            vhat = v_new / bc2
            delta = (mhat / (torch.sqrt(vhat) + cfg.eps)
                     + cfg.weight_decay * p.to(F32))
            p_new = p.to(F32) - lr * delta
            if inplace:
                p.copy_(p_new)
                m.copy_(m_new)
                v.copy_(v_new)
                new_p[k], new_m[k], new_v[k] = p, m, v
            else:
                new_p[k] = p_new.to(p.dtype)
                new_m[k], new_v[k] = m_new.to(m.dtype), v_new.to(v.dtype)
    return new_p, AdamState(step, new_m, new_v, err), {
        "lr": lr, "grad_norm": gnorm}
