"""Transformer building blocks of the dense LM stack: RMSNorm, RoPE, chunked
attention (GQA, sliding window) and the FFN variants, the reference's
``src/repro/models/layers.py`` in PyTorch.

Conventions, as the reference's:

* The functions take a parameter tree: a dict of tensors with the
  reference's key names (``{"wq": ..., "wk": ...}``). The ``nn.Module``
  classes below own those tensors as ``nn.Parameter``s under the same
  names, and :func:`param_tree` reads a module back as such a dict.
* A product ``jnp.einsum(..., preferred_element_type=F32).astype(dt)``
  becomes :func:`dot`: the operands are promoted as ``jnp`` promotes them
  (bf16 with f32 is f32), accumulation is f32, and the output is rounded
  once to ``dt``. Where the reference keeps the f32 output (the loss's
  logits, the attention tiles), :func:`dot` upcasts the bf16 operands to
  f32 (exact) and runs an f32 product: a bf16 ``torch.matmul`` would round
  its output to bf16. TF32 is off (``repro_torch/__init__.py``), and so is
  cuBLAS's reduced-precision bf16 reduction, so a bf16 product accumulates
  in f32 as the reference's does.
* Attention is **chunked** (flash-style online softmax over kv tiles) in
  plain torch, each kv step checkpointed when gradients are taken, so the
  (S, S) scores never exist and backward recomputes each tile.
* No sharding constraint: on one card the reference's ``constrain`` is the
  identity (multi-card training is ROADMAP item 14d).

MoE (``MoeSpec``) is the dataclass only here: building a MoE block raises
``NotImplementedError`` naming ROADMAP item 14b.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
NEG_INF = -1e30


def dot(eq: str, a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """``jnp.einsum(eq, a, b, preferred_element_type=F32).astype(out_dtype)``.
    An f32 output (or an f32 operand) runs the product in f32 on f32
    operands; a bf16 pair whose output is rounded to bf16 anyway runs the
    bf16 product (f32 accumulation, one rounding)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    if out_dtype == F32 or dt == F32:
        return torch.einsum(eq, a.to(F32), b.to(F32)).to(out_dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt)).to(out_dtype)


def normal(gen: torch.Generator, shape, scale: float, dtype=F32):
    """N(0, 1)·scale drawn in f32 on ``gen``'s device, then cast."""
    t = torch.randn(shape, generator=gen, device=gen.device, dtype=F32)
    return (t * scale).to(dtype)


def param_tree(module: nn.Module, cast=None):
    """The module's parameters as the reference's nested dict (children
    by name; a ``ModuleList`` as a list). ``cast``: the train step's
    compute-dtype cast of every f32 parameter with ndim > 1
    (``src/repro/train/steps.py:84-87``), in the autograd graph."""
    if isinstance(module, nn.ModuleList):
        return [param_tree(m, cast) for m in module]
    out = {}
    for name, p in module.named_parameters(recurse=False):
        out[name] = (p.to(cast) if cast is not None and p.dtype == F32
                     and p.dim() > 1 else p)
    for name, child in module.named_children():
        out[name] = param_tree(child, cast)
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(params, x, eps: float = 1e-6, offset: float = 0.0):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (offset + params["scale"].to(F32))).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device=None, dtype=F32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=dtype))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """Rotary embeddings. x: (..., S, H, D); positions: (..., S). The
    frequencies are ``theta ** (-arange/half)`` in f32, as the reference's."""
    d = x.shape[-1]
    half = d // 2
    expo = -torch.arange(0, half, dtype=F32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=F32, device=x.device), expo)
    ang = positions[..., :, None].to(F32) * freq            # (..., S, half)
    ang = ang[..., None, :]                                 # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked (memory-efficient) attention core
# ---------------------------------------------------------------------------

def _attend_block(q, k, v, bias):
    """One (qc, kc) tile → (unnormalised out, row max, row sum of exp).
    q: (B, H, Qc, D), k/v: (B, H, Kc, D), bias: (1, 1, Qc, Kc)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), k.to(F32))
    s = s * (1.0 / math.sqrt(q.shape[-1])) + bias
    m = torch.amax(s, dim=-1)                               # (B, H, Qc)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.to(F32))
    return o, m, l


def _kv_step(o_acc, m_acc, l_acc, qb, kb, vb, bias):
    o, m, l = _attend_block(qb, kb, vb, bias)
    m_new = torch.maximum(m_acc, m)
    scale_old = torch.exp(m_acc - m_new)
    scale_new = torch.exp(m - m_new)
    o_acc = o_acc * scale_old[..., None] + o * scale_new[..., None]
    l_acc = l_acc * scale_old + l * scale_new
    return o_acc, m_new, l_acc


def _tile_live(q0: int, q1: int, k0: int, k1: int, causal: bool,
               window: int | None) -> bool:
    """Whether any (query, key) pair of the tile with absolute positions
    q0..q1 × k0..k1 is unmasked."""
    if causal and k0 > q1:
        return False
    if window is not None and k1 <= q0 - window:
        return False
    return True


def chunked_attention(q, k, v, *, causal: bool, window: int | None,
                      q_offset: int, k_chunk: int = 1024,
                      q_chunk: int = 1024):
    """Flash-style attention (the reference's ``lax.scan`` over kv chunks
    with a running log-sum-exp, ``layers.py:107-170``).

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) and (B, Hkv, Sk, Dv), GQA by
    head repeat. ``q_offset``: absolute position of q[0]. ``window``:
    sliding-window size or None. Returns (B, Hq, Sq, Dv) in q.dtype.

    Masking adds the finite ``NEG_INF``, as the reference does. A tile in
    which every (query, key) pair is masked (past the diagonal, or before
    the window) is skipped: the reference's update gives it the weight
    exp(NEG_INF − m) = 0 exactly, so skipping it leaves the same bits.
    """
    b, hq, sq, d = q.shape
    dv = v.shape[-1]
    hkv = k.shape[1]
    if hq != hkv:
        k = torch.repeat_interleave(k, hq // hkv, dim=1)
        v = torch.repeat_interleave(v, hq // hkv, dim=1)
    sk = k.shape[2]
    q_offset = int(q_offset)

    q_chunk = min(q_chunk, sq)
    k_chunk = min(k_chunk, sk)
    nq = -(-sq // q_chunk)
    nk = -(-sk // k_chunk)
    # pad to chunk multiples (padded kv masked out; padded q sliced off)
    qp = F.pad(q, (0, 0, 0, nq * q_chunk - sq))
    kp = F.pad(k, (0, 0, 0, nk * k_chunk - sk))
    vp = F.pad(v, (0, 0, 0, nk * k_chunk - sk))
    dev = q.device
    remat = torch.is_grad_enabled()

    outs = []
    for qi in range(nq):
        qb = qp[:, :, qi * q_chunk:(qi + 1) * q_chunk]
        q0 = q_offset + qi * q_chunk
        qpos = q0 + torch.arange(q_chunk, device=dev)
        o_acc = torch.zeros((b, hq, q_chunk, dv), dtype=F32, device=dev)
        m_acc = torch.full((b, hq, q_chunk), NEG_INF, dtype=F32, device=dev)
        l_acc = torch.zeros((b, hq, q_chunk), dtype=F32, device=dev)
        for ki in range(nk):
            k0 = ki * k_chunk
            if not _tile_live(q0, q0 + q_chunk - 1, k0,
                              min(k0 + k_chunk, sk) - 1, causal, window):
                continue
            kpos = k0 + torch.arange(k_chunk, device=dev)
            valid = (kpos[None, :] < sk)
            if causal:
                valid = valid & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                valid = valid & (kpos[None, :] > qpos[:, None] - window)
            bias = torch.where(valid, 0.0, NEG_INF).to(F32)[None, None]
            kb = kp[:, :, k0:k0 + k_chunk]
            vb = vp[:, :, k0:k0 + k_chunk]
            if remat:   # recompute the tile's scores in backward
                o_acc, m_acc, l_acc = checkpoint(
                    _kv_step, o_acc, m_acc, l_acc, qb, kb, vb, bias,
                    use_reentrant=False)
            else:
                o_acc, m_acc, l_acc = _kv_step(o_acc, m_acc, l_acc, qb, kb,
                                               vb, bias)
        outs.append(o_acc / torch.clamp(l_acc[..., None], min=1e-30))
    out = torch.cat(outs, dim=2)
    return out[:, :, :sq].to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    causal: bool = True
    window: int | None = None      # sliding-window size (None = full)
    qk_norm: bool = False          # gemma3-style per-head RMS on q/k
    qkv_bias: bool = False         # qwen-style bias
    rope_theta: float = 10000.0


class Attention(nn.Module):
    """The parameters of one attention mixer (the reference's
    ``attn_init``): wq (d, H, Dh), wk/wv (d, Hk, Dh), wo (H, Dh, d),
    optional bq/bk/bv and qnorm/knorm."""

    def __init__(self, spec: AttnSpec, gen: torch.Generator, dtype=F32):
        super().__init__()
        d, h, hk, dh = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.d_head
        sc = 1.0 / math.sqrt(d)
        self.wq = nn.Parameter(normal(gen, (d, h, dh), sc, dtype))
        self.wk = nn.Parameter(normal(gen, (d, hk, dh), sc, dtype))
        self.wv = nn.Parameter(normal(gen, (d, hk, dh), sc, dtype))
        self.wo = nn.Parameter(normal(gen, (h, dh, d),
                                      1.0 / math.sqrt(h * dh), dtype))
        dev = gen.device
        if spec.qkv_bias:
            self.bq = nn.Parameter(torch.zeros((h, dh), dtype=dtype,
                                               device=dev))
            self.bk = nn.Parameter(torch.zeros((hk, dh), dtype=dtype,
                                               device=dev))
            self.bv = nn.Parameter(torch.zeros((hk, dh), dtype=dtype,
                                               device=dev))
        if spec.qk_norm:
            self.qnorm = nn.Parameter(torch.ones((dh,), dtype=dtype,
                                                 device=dev))
            self.knorm = nn.Parameter(torch.ones((dh,), dtype=dtype,
                                                 device=dev))


def _headwise_rms(x, scale):
    xf = x.to(F32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (y * scale.to(F32)).to(x.dtype)


def attn_qkv(params, spec: AttnSpec, x, positions):
    """Project to rotary q, k, v. x: (B, S, d) → q (B,H,S,Dh), k/v (B,Hk,S,Dh)."""
    q = dot("bsd,dhk->bhsk", x, params["wq"], x.dtype)
    k = dot("bsd,dhk->bhsk", x, params["wk"], x.dtype)
    v = dot("bsd,dhk->bhsk", x, params["wv"], x.dtype)
    if spec.qkv_bias:
        q = q + params["bq"][None, :, None, :].to(x.dtype)
        k = k + params["bk"][None, :, None, :].to(x.dtype)
        v = v + params["bv"][None, :, None, :].to(x.dtype)
    if spec.qk_norm:
        q = _headwise_rms(q, params["qnorm"])
        k = _headwise_rms(k, params["knorm"])
    # rope takes (..., S, H, D): rotate in (B, S, H, D) and back
    q = rope(q.transpose(1, 2), positions, spec.rope_theta).transpose(1, 2)
    k = rope(k.transpose(1, 2), positions, spec.rope_theta).transpose(1, 2)
    return q, k, v


def attn_out(params, o, dtype):
    """The out-projection: (B, H, S, Dh) → (B, S, d) in ``dtype``."""
    return dot("bhsk,hkd->bsd", o, params["wo"], dtype)


def attn_forward(params, spec: AttnSpec, x, positions, *, q_chunk=1024,
                 k_chunk=1024):
    """Self-attention over a full sequence (train / prefill)."""
    q, k, v = attn_qkv(params, spec, x, positions)
    o = chunked_attention(q, k, v, causal=spec.causal, window=spec.window,
                          q_offset=0, q_chunk=q_chunk, k_chunk=k_chunk)
    return attn_out(params, o, x.dtype)


def attn_decode(params, spec: AttnSpec, x, cache_k, cache_v, cache_len):
    """Single-token decode: x (B, 1, d); cache (B, Hk, Smax, Dh), written
    in place at ``cache_len``. Returns (out (B, 1, d), cache_k, cache_v)."""
    b = x.shape[0]
    t = int(cache_len)
    pos = torch.full((b, 1), t, dtype=torch.int32, device=x.device)
    q, k, v = attn_qkv(params, spec, x, pos)
    cache_k[:, :, t:t + 1] = k.to(cache_k.dtype)
    cache_v[:, :, t:t + 1] = v.to(cache_v.dtype)
    smax = cache_k.shape[2]
    hq, hk = spec.n_heads, spec.n_kv_heads
    kk = torch.repeat_interleave(cache_k, hq // hk, dim=1)
    vv = torch.repeat_interleave(cache_v, hq // hk, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32),
                     kk.to(F32)) / math.sqrt(spec.d_head)
    kpos = torch.arange(smax, device=x.device)
    valid = kpos <= t
    if spec.window is not None:
        valid = valid & (kpos > t - spec.window)
    s = torch.where(valid[None, None, None], s, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", pattn, vv.to(F32)).to(x.dtype)
    return attn_out(params, o, x.dtype), cache_k, cache_v


# ---------------------------------------------------------------------------
# FFN variants
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FfnSpec:
    d_model: int
    d_ff: int
    kind: str = "swiglu"           # swiglu | geglu | relu2 | gelu


class Ffn(nn.Module):
    """The parameters of one dense FFN (the reference's ``ffn_init``):
    w_in (d, f), w_out (f, d) and, gated, w_gate (d, f)."""

    def __init__(self, spec: FfnSpec, gen: torch.Generator, dtype=F32):
        super().__init__()
        d, f = spec.d_model, spec.d_ff
        sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
        self.w_in = nn.Parameter(normal(gen, (d, f), sc_in, dtype))
        self.w_out = nn.Parameter(normal(gen, (f, d), sc_out, dtype))
        if spec.kind in ("swiglu", "geglu"):
            self.w_gate = nn.Parameter(normal(gen, (d, f), sc_in, dtype))


def ffn_hidden(params, spec: FfnSpec, x):
    """The FFN's hidden activations (B, S, d_ff), before ``w_out``."""
    h = dot("bsd,df->bsf", x, params["w_in"], x.dtype)
    if spec.kind in ("swiglu", "geglu"):
        g = dot("bsd,df->bsf", x, params["w_gate"], x.dtype)
        act = F.silu(g) if spec.kind == "swiglu" else F.gelu(
            g, approximate="tanh")
        return act * h
    if spec.kind == "relu2":
        return torch.square(F.relu(h))
    return F.gelu(h, approximate="tanh")


def ffn_forward(params, spec: FfnSpec, x):
    h = ffn_hidden(params, spec, x)
    return dot("bsf,fd->bsd", h, params["w_out"], x.dtype)


# ---------------------------------------------------------------------------
# MoE: the spec only (ROADMAP item 14b)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoeSpec:
    d_model: int
    d_expert: int
    n_routed: int
    n_shared: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 128          # dispatch group (bounds T×E×C cost)
    ffn_kind: str = "swiglu"
