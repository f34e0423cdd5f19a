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
* The "model" axis splits compute where the rules split the leaves
  (:mod:`repro_torch.pshard`): a layer reads its split from the shapes
  of the leaves it is given (a rank's block of a leaf cut over "model")
  and :func:`repro_torch.pshard.model_shard`. Attention then computes
  the rank's query heads (and the kv heads they read), the FFN the
  rank's hidden columns and MoE the rank's experts, each inside a split
  region (:func:`repro_torch.pshard.enter` … :func:`repro_torch.pshard.
  leave`: the row-parallel product's f32 partials are summed over
  "model", then rounded once). MoE routing reads the rank's place in the
  batch: its groups are the whole batch's (:func:`moe_route`).

MoE (:func:`moe_forward`) is the reference's grouped top-k dispatch with
capacity, its one-hot dispatch and combine products included (see
:func:`moe_route`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import pshard
from ..pshard import P

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


class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the "meta" device, which has
    none: a model built with it has its parameters' shapes and dtypes and
    no values (a full config's shapes without its memory)."""
    device = torch.device("meta")


def normal(gen: torch.Generator, shape, scale: float, dtype=F32):
    """N(0, 1)·scale drawn in f32 on ``gen``'s device, then cast."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=gen.device)
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


def tree_from_named(named: dict):
    """{``named_parameters`` name: tensor} → the tree :func:`param_tree`
    gives for the module they came from (a numeric name is a list
    index)."""
    out: dict = {}
    for name, t in named.items():
        node, parts = out, name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(out)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(params, x, eps: float = 1e-6, offset: float = 0.0):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (offset + params["scale"].to(F32))).to(x.dtype)


class RMSNorm(nn.Module):
    SPECS = {"scale": P(None)}

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

    SPECS = {"wq": P("embed", "heads", None), "wk": P("embed", "kv", None),
             "wv": P("embed", "kv", None), "wo": P("heads", None, "embed"),
             "bq": P("heads", None), "bk": P("kv", None),
             "bv": P("kv", None), "qnorm": P(None), "knorm": P(None)}
    # the split region: where wq's heads are cut over "model"; every
    # leaf is read inside it, so those replicated over "model" have
    # gradients that are each model rank's part
    SPLIT = pshard.Split("wq", 1)

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


def _project(params, spec: AttnSpec, x, positions, w: str, b: str,
             norm: str | None, heads: slice | None = None):
    """One rotary (q or k) or plain (v) projection of x (B, S, d) onto the
    heads of ``params[w]`` (``heads``: a slice of them) → (B, h, S, Dh),
    with its bias and per-head norm."""
    wt = params[w] if heads is None else params[w][:, heads]
    y = dot("bsd,dhk->bhsk", x, wt, x.dtype)
    if spec.qkv_bias:
        bias = params[b] if heads is None else params[b][heads]
        y = y + bias[None, :, None, :].to(x.dtype)
    if norm is not None and spec.qk_norm:
        y = _headwise_rms(y, params[norm])
    if norm is not None:        # rope takes (..., S, H, D)
        y = rope(y.transpose(1, 2), positions, spec.rope_theta).transpose(
            1, 2)
    return y


def attn_qkv(params, spec: AttnSpec, x, positions):
    """Project to rotary q, k, v. x: (B, S, d) → q (B,H,S,Dh), k/v
    (B,Hk,S,Dh), over the heads of the leaves given (a rank's block)."""
    return (_project(params, spec, x, positions, "wq", "bq", "qnorm"),
            _project(params, spec, x, positions, "wk", "bk", "knorm"),
            _project(params, spec, x, positions, "wv", "bv", None))


def attn_out(params, o, dtype):
    """The out-projection: (B, H, S, Dh) → (B, S, d) in ``dtype``."""
    return dot("bhsk,hkd->bsd", o, params["wo"], dtype)


class HeadSplit(NamedTuple):
    """How a rank's attention leaves cut the heads over "model": its
    query heads [q0, q0 + hq) of ``n_heads``; ``kv_cut`` where the kv
    leaves are cut too (the rank's kv heads are then those its query
    heads read), else they hold every kv head."""
    sh: "pshard.ModelShard"
    q0: int
    hq: int
    kv_cut: bool

    def kv_of_q(self, spec: AttnSpec) -> list[int]:
        """The global kv head each of the rank's query heads reads."""
        g = spec.n_heads // spec.n_kv_heads
        return [(self.q0 + j) // g for j in range(self.hq)]


def head_split(params, spec: AttnSpec) -> HeadSplit | None:
    """The rank's :class:`HeadSplit`, or None where the query heads are
    whole (the rules leave them replicated, or there is no model axis)."""
    hq = params["wq"].shape[1]
    if hq == spec.n_heads:
        return None
    sh = pshard.model_shard()
    return HeadSplit(sh, sh.index * hq, hq,
                     params["wk"].shape[1] < spec.n_kv_heads)


def _kv_for_q(t, hs: HeadSplit, spec: AttnSpec, first: int):
    """k or v (B, h, S, Dh) over kv heads [first, first + h) → one head per
    query head of the rank, the one it reads."""
    idx = [k - first for k in hs.kv_of_q(spec)]
    if idx == list(range(t.shape[1])):
        return t
    return t[:, idx]


def _kv_span(hs: HeadSplit, spec: AttnSpec) -> slice:
    need = hs.kv_of_q(spec)
    return slice(need[0], need[-1] + 1)


def attn_forward(params, spec: AttnSpec, x, positions, *, q_chunk=1024,
                 k_chunk=1024):
    """Self-attention over a full sequence (train / prefill)."""
    return attn_prefill(params, spec, x, positions, None, q_chunk=q_chunk,
                        k_chunk=k_chunk)[0]


def attn_prefill(params, spec: AttnSpec, x, positions, cache: str | None,
                 *, q_chunk=1024, k_chunk=1024):
    """Self-attention over a full sequence → (out (B, S, d), the rank's
    (k, v) cache or None): ``cache`` None takes no cache; else the
    cache's layout, as :func:`attn_cache_cut` names it (``"whole"``,
    ``"heads"`` or ``"seq"``).

    With the query heads cut over "model" (:func:`head_split`) the rank
    computes its heads inside a split region. Its kv heads are its block
    where the kv leaves are cut; where they are replicated, it projects
    the kv heads its query heads read (all of them where a cache of every
    kv head is asked for) and gives each query head its own."""
    hs = head_split(params, spec)
    if hs is None:
        q, k, v = attn_qkv(params, spec, x, positions)
        o = chunked_attention(q, k, v, causal=spec.causal,
                              window=spec.window, q_offset=0,
                              q_chunk=q_chunk, k_chunk=k_chunk)
        out = attn_out(params, o, x.dtype)
        return out, (None if cache is None else _cache_block(
            k, v, cache, pshard.model_shard()))
    x = pshard.enter(x, hs.sh)
    q = _project(params, spec, x, positions, "wq", "bq", "qnorm")
    every = cache is not None and cache != "heads"
    span = None if hs.kv_cut or every else _kv_span(hs, spec)
    k = _project(params, spec, x, positions, "wk", "bk", "knorm", span)
    v = _project(params, spec, x, positions, "wv", "bv", None, span)
    if hs.kv_cut:
        ka, va = k, v
    else:
        first = 0 if span is None else span.start
        ka, va = (_kv_for_q(k, hs, spec, first),
                  _kv_for_q(v, hs, spec, first))
    o = chunked_attention(q, ka, va, causal=spec.causal, window=spec.window,
                          q_offset=0, q_chunk=q_chunk, k_chunk=k_chunk)
    out = pshard.leave(attn_out(params, o, F32), hs.sh).to(x.dtype)
    if cache is None:
        return out, None
    if every and hs.kv_cut:         # a cache of every kv head
        k = pshard.all_gather_dim(k, hs.sh, 1, "cache")
        v = pshard.all_gather_dim(v, hs.sh, 1, "cache")
    return out, _cache_block(k, v, cache, hs.sh)


def _cache_block(k, v, cache: str, sh) -> tuple:
    """The rank's block of the (k, v) cache in the layout ``cache``: its
    kv heads as given (``"heads"``, ``"whole"``), or its positions
    (``"seq"``)."""
    if cache != "seq":
        return k, v
    first, n = sh.block(k.shape[2])
    return k[:, :, first:first + n], v[:, :, first:first + n]


def attn_cache_cut(spec: AttnSpec, seq: int) -> str:
    """The layout of an attention cache of ``seq`` positions on this
    rank's model axis: ``"heads"`` where its kv heads are cut over
    "model", ``"seq"`` where its positions are, else ``"whole"``, as
    :func:`repro_torch.pshard.resolve_spec` resolves the reference's
    cache spec (kv heads over "model" when 16 divides them, else the
    sequence)."""
    sh = pshard.model_shard()
    if sh is None:
        return "whole"
    if spec.n_kv_heads % 16 == 0:
        return "heads" if spec.n_kv_heads % sh.count == 0 else "whole"
    return "seq" if seq % sh.count == 0 else "whole"


def attn_decode(params, spec: AttnSpec, x, cache_k, cache_v, cache_len,
                cut: str = "whole"):
    """Single-token decode: x (B, 1, d); the rank's cache (B, Hk, Smax,
    Dh) in the layout ``cut`` (:func:`attn_cache_cut` of the whole
    cache's Smax), written in place at ``cache_len``. Returns (out (B, 1,
    d), cache_k, cache_v).

    On a sequence-cut cache (``"seq"``) the rank attends every query head
    over its positions: the one-token q is gathered over "model", each
    rank's partial (max, sum, output) is combined with a MAX and a SUM
    over "model", and the rank keeps its heads for ``wo``. Only the rank
    that holds position ``cache_len`` writes the new k and v."""
    b = x.shape[0]
    t = int(cache_len)
    pos = torch.full((b, 1), t, dtype=torch.int32, device=x.device)
    hs = head_split(params, spec)
    sh = pshard.model_shard()
    if hs is not None:
        x = pshard.enter(x, hs.sh)
    q = _project(params, spec, x, pos, "wq", "bq", "qnorm")
    k = _project(params, spec, x, pos, "wk", "bk", "knorm")
    v = _project(params, spec, x, pos, "wv", "bv", None)
    if cut != "heads" and hs is not None and hs.kv_cut:
        k = pshard.all_gather_dim(k, sh, 1, "decode_kv")
        v = pshard.all_gather_dim(v, sh, 1, "decode_kv")
    first = 0
    if cut == "seq":
        first = sh.block(cache_k.shape[2] * sh.count)[0]
    local = t - first
    if 0 <= local < cache_k.shape[2]:
        cache_k[:, :, local:local + 1] = k.to(cache_k.dtype)
        cache_v[:, :, local:local + 1] = v.to(cache_v.dtype)
    kpos = first + torch.arange(cache_k.shape[2], device=x.device)
    valid = kpos <= t
    if spec.window is not None:
        valid = valid & (kpos > t - spec.window)
    if cut == "seq":
        o = _decode_seq(q, cache_k, cache_v, valid, spec, hs, sh)
    else:
        if hs is None or cut == "heads":
            kk = torch.repeat_interleave(cache_k, q.shape[1]
                                         // cache_k.shape[1], dim=1)
            vv = torch.repeat_interleave(cache_v, q.shape[1]
                                         // cache_v.shape[1], dim=1)
        else:
            kk = _kv_for_q(cache_k, hs, spec, 0)
            vv = _kv_for_q(cache_v, hs, spec, 0)
        s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32),
                         kk.to(F32)) / math.sqrt(spec.d_head)
        s = torch.where(valid[None, None, None], s, NEG_INF)
        pattn = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", pattn, vv.to(F32)).to(x.dtype)
    if hs is None:
        return attn_out(params, o, x.dtype), cache_k, cache_v
    out = pshard.leave(attn_out(params, o, F32), hs.sh).to(x.dtype)
    return out, cache_k, cache_v


def _decode_seq(q, cache_k, cache_v, valid, spec: AttnSpec, hs, sh):
    """Decode attention over a sequence-cut cache: every query head (q
    gathered over "model" where the rank holds some) against the rank's
    positions, the softmax's pieces combined over "model" → the rank's
    heads' output (B, h, 1, Dh) in q's dtype."""
    dt = q.dtype
    if hs is not None:
        q = pshard.all_gather_dim(q, sh, 1, "decode_q")
    g = q.shape[1] // cache_k.shape[1]
    kk = torch.repeat_interleave(cache_k, g, dim=1)
    vv = torch.repeat_interleave(cache_v, g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32),
                     kk.to(F32)) / math.sqrt(spec.d_head)
    s = torch.where(valid[None, None, None], s, NEG_INF)
    o = combine_seq(s, "bhqk,bhkd->bhqd", vv.to(F32), sh, dt)
    if hs is not None:
        o = o[:, hs.q0:hs.q0 + hs.hq]
    return o


def combine_seq(s, eq: str, values, sh, dt):
    """The softmax-weighted sum over positions cut over "model": the f32
    scores ``s`` (B, H, 1, T) against the rank's f32 ``values`` by the
    einsum ``eq``, the rank's maxima combined by a MAX, the numerators
    and the denominator by one f32 SUM → (B, H, 1, D) in ``dt``."""
    top = pshard.model_max(torch.amax(s, dim=-1), sh, "decode_max")
    p = torch.exp(s - top[..., None])
    parts = torch.cat([torch.einsum(eq, p, values),
                       torch.sum(p, dim=-1)[..., None]], dim=-1)
    parts = pshard.leave(parts, sh, "decode_sum")
    return (parts[..., :-1] / parts[..., -1:]).to(dt)


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

    SPECS = {"w_in": P("embed", "ffn"), "w_out": P("ffn", "embed"),
             "w_gate": P("embed", "ffn")}

    def __init__(self, spec: FfnSpec, gen: torch.Generator, dtype=F32):
        super().__init__()
        d, f = spec.d_model, spec.d_ff
        sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
        self.w_in = nn.Parameter(normal(gen, (d, f), sc_in, dtype))
        self.w_out = nn.Parameter(normal(gen, (f, d), sc_out, dtype))
        if spec.kind in ("swiglu", "geglu"):
            self.w_gate = nn.Parameter(normal(gen, (d, f), sc_in, dtype))


def ffn_hidden(params, spec: FfnSpec, x):
    """The FFN's hidden activations (B, S, f), before ``w_out``: the
    rank's f columns where ``w_in`` is its block."""
    h = dot("bsd,df->bsf", x, params["w_in"], x.dtype)
    if spec.kind in ("swiglu", "geglu"):
        g = dot("bsd,df->bsf", x, params["w_gate"], x.dtype)
        act = F.silu(g) if spec.kind == "swiglu" else F.gelu(
            g, approximate="tanh")
        return act * h
    if spec.kind == "relu2":
        return torch.square(F.relu(h))
    return F.gelu(h, approximate="tanh")


def ffn_forward(params, spec: FfnSpec, x, tag: str = "region"):
    """The FFN; with its hidden width cut over "model" (``w_in`` and
    ``w_gate`` column-parallel, ``w_out`` row-parallel) the rank's part
    inside a split region (its sums counted under ``tag``)."""
    if params["w_in"].shape[1] == spec.d_ff:
        h = ffn_hidden(params, spec, x)
        return dot("bsf,fd->bsd", h, params["w_out"], x.dtype)
    sh = pshard.model_shard()
    h = ffn_hidden(params, spec, pshard.enter(x, sh, tag))
    part = dot("bsf,fd->bsd", h, params["w_out"], F32)
    return pshard.leave(part, sh, tag).to(x.dtype)


# ---------------------------------------------------------------------------
# MoE (shared + routed experts, grouped GShard dispatch)
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

    def shared_spec(self) -> FfnSpec:
        """The shared experts as one dense FFN of ``n_shared`` widths."""
        return FfnSpec(self.d_model, self.d_expert * self.n_shared,
                       self.ffn_kind)


class Moe(nn.Module):
    """The parameters of one MoE FFN (the reference's ``moe_init``):
    ``router`` (d, e), kept in f32 whatever ``dtype`` is; ``w_in`` and
    ``w_gate`` (e, d, f); ``w_out`` (e, f, d); and, with shared experts,
    ``shared``, a dense FFN of width f·n_shared."""

    SPECS = {"router": P("embed", None), "w_in": P("experts", "embed", None),
             "w_gate": P("experts", "embed", None),
             "w_out": P("experts", None, "embed")}
    # as Attention.SPLIT: the experts cut over "model"; the router is
    # read inside the region (the combine weights)
    SPLIT = pshard.Split("w_in", 0, ("router",))

    def __init__(self, spec: MoeSpec, gen: torch.Generator, dtype=F32):
        super().__init__()
        d, f, e = spec.d_model, spec.d_expert, spec.n_routed
        sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
        self.router = nn.Parameter(normal(gen, (d, e), sc_in, F32))
        self.w_in = nn.Parameter(normal(gen, (e, d, f), sc_in, dtype))
        self.w_gate = nn.Parameter(normal(gen, (e, d, f), sc_in, dtype))
        self.w_out = nn.Parameter(normal(gen, (e, f, d), sc_out, dtype))
        if spec.n_shared:
            self.shared = Ffn(spec.shared_spec(), gen, dtype)


class MoeRoute(NamedTuple):
    """Where :func:`moe_route` sends each (token, choice) pair. The routed
    tokens are ``ng`` groups of ``g`` (the last one padded); ``[..., j]``
    is a token's j-th choice, in ``top_k``'s descending order. The
    caller's T tokens are rows [lo, lo + T) of the flattened groups,
    whose row 0 is token ``first`` of the whole batch (both 0 unless a
    data-parallel rank routes groups that other ranks' tokens share)."""
    topv: torch.Tensor     # (ng, g, k) f32 weights, renormalised
    topi: torch.Tensor     # (ng, g, k) the chosen experts
    pos: torch.Tensor      # (ng, g, k) the pair's slot in its expert's buffer
    keep: torch.Tensor     # (ng, g, k) 0 ≤ pos < cap, and the caller's token
    cap: int               # slots per expert and group
    tokens: int            # T, the caller's tokens
    lo: int = 0            # the caller's first row in the groups
    first: int = 0         # the batch's index of the groups' row 0


def _window(spec: MoeSpec, x):
    """x (..., d) → (the groups' tokens (ng, g, d), T, lo, first, the
    batch shard or None): the groups the reference forms over the whole
    batch's flattened tokens that hold this caller's T tokens, with the
    other tokens (another rank's, or the last group's padding) zero."""
    d = x.shape[-1]
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    sh = pshard.batch_shard()
    if sh is not None and sh.count == 1:
        sh = None
    whole = t if sh is None else t * sh.count
    g = min(spec.group_size, whole)
    if sh is None or t % g == 0:         # whole groups of the caller's own
        ng = -(-t // g)
        return (F.pad(tokens, (0, 0, 0, ng * g - t)).reshape(ng, g, d), t,
                0, 0 if sh is None else sh.index * t, None)
    start = sh.index * t                 # the caller's first token
    first = start // g * g
    ng = -(-(start + t) // g) - first // g
    lo = start - first
    return (F.pad(tokens, (0, 0, lo, ng * g - lo - t)).reshape(ng, g, d), t,
            lo, first, sh)


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` as a bool comparison with ``arange(n)``: the
    same values, by the same aten ops on real and on fake tensors
    (``F.one_hot`` checks its indices on the host for a CPU tensor and
    decomposes otherwise under ``FakeTensorMode``, so a dry run would
    count other ops than the step it stands for)."""
    return idx.unsqueeze(-1) == torch.arange(n, device=idx.device)


def moe_route(params, spec: MoeSpec, x) -> MoeRoute:
    """The reference's routing (``layers.py:384-405``) of x (..., d).

    Top-k over the router's softmax probabilities (f32; a router cast to
    bf16 by the train step is upcast, its values the rounded ones, as jnp
    promotes it), renormalised as ``topv / (Σ topv + 1e-9)``. A pair's
    slot is the count of earlier pairs on its expert in the group, taken
    over the flattened (g, k) axis token-major (an exact integer cumsum);
    it is kept when the slot is below ``cap = max(1, int(g·k/e·
    capacity_factor))``.

    The padded (zero) tokens are routed too. Their probabilities tie
    exactly, and ``torch.topk`` may order ties otherwise than
    ``lax.top_k``; but they come after every real token of the last group
    in the cumsum, so they take no real token's slot, and their rows are
    sliced off: a real token's output does not depend on their choices.
    Only ``topv`` carries a gradient (into the router), as in the
    reference.

    **Over the whole batch.** On a data-parallel rank (inside
    :func:`repro_torch.pshard.batch_context`) the groups are the
    reference's over the whole batch: g = min(group_size, the batch's
    tokens), so ``cap`` is the whole batch's. Where a group holds other
    ranks' tokens (g does not divide the rank's T), every rank's top-k
    choices are gathered along the batch axes (integers, no gradient:
    one all-gather of (T, k)), so each of the caller's pairs takes the
    slot the whole batch gives it; only the caller's pairs are kept.
    Dispatch, experts and combine stay on the caller's tokens.
    """
    e, k = spec.n_routed, spec.top_k
    tokens, t, lo, first, sh = _window(spec, x)
    ng, g, _ = tokens.shape
    cap = max(1, int(g * k / e * spec.capacity_factor))
    logits = dot("ngd,de->nge", tokens.to(F32), params["router"], F32)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)            # descending
    topv = topv / (torch.sum(topv, dim=-1, keepdim=True) + 1e-9)
    mine = None
    if sh is not None:
        flat = topi.reshape(ng * g, k)
        every = pshard.all_gather_rows(flat[lo:lo + t].contiguous(),
                                       sh.mesh, sh.axes, "route")
        real = min(ng * g, every.shape[0] - first)       # then padding
        topi = torch.cat([every[first:first + real], flat[real:]]).reshape(
            ng, g, k)
        mine = torch.zeros(ng * g, 1, dtype=torch.bool, device=x.device)
        mine[lo:lo + t] = True
        mine = mine.reshape(ng, g, 1)
    onehot = one_hot(topi, e)                             # (ng, g, k, e)
    seen = torch.cumsum(onehot.reshape(ng, g * k, e), dim=1).reshape(
        ng, g, k, e)
    pos = torch.sum(seen * onehot, dim=-1) - 1
    keep = pos < cap if mine is None else (pos < cap) & mine
    return MoeRoute(topv, topi, pos, keep, cap, t, lo, first)


def expert_split(params, spec: MoeSpec) -> "pshard.ModelShard | None":
    """The "model" axis where the routed experts are cut over it (the
    rank holds ``w_in.shape[0]`` of them, block ``index``), or None where
    every rank holds them all (the rules leave them replicated when
    their count does not divide the axis, or there is no model axis)."""
    if params["w_in"].shape[0] == spec.n_routed:
        return None
    return pshard.model_shard()


def moe_forward(params, spec: MoeSpec, x):
    """Grouped top-k routing with capacity, the reference's
    ``moe_forward`` (``layers.py:375-444``): x (B, S, d) → (B, S, d).
    Dropped pairs (over capacity) add nothing: their tokens keep the
    residual path.

    Dispatch and combine are the reference's one-hot (ng, g, e, cap)
    products, not an index scatter and gather: each slot holds at most
    one token, so dispatch is exact, and combine sums a token's at most k
    weighted expert outputs in f32 and rounds once, its weights rounded
    to ``x.dtype`` first as the reference's ``combine``; the products are
    deterministic (no atomics), so a checkpointed layer's recompute
    gives the same bits, and at deepseek-v2-lite's width each one-hot is
    (128, 128, 64, 15), 31 MB in bf16.

    **Experts over "model"** (:func:`expert_split`). Every model rank
    holds every token of its data row and routes them all, as the
    reference's ``("batch", None, None)`` tokens; it builds dispatch and
    combine for its own experts alone (its block of the one-hot's expert
    axis), fills their buffers from its tokens (no all-to-all: the
    reference's dispatch product is local), runs them, and takes the
    combine over its experts as an f32 partial, summed over "model" and
    rounded once. Routing sits inside the split region too: the combine
    weights are read there, so the router's gradient is each rank's part
    (its plan is ``partial``) and x's gradient is summed on the way out.
    The shared experts are a dense FFN in a region of their own
    (:func:`ffn_forward`), added after each output is rounded, as the
    reference adds them.
    """
    sh = expert_split(params, spec)
    xr = x if sh is None else pshard.enter(x, sh, "experts")
    r = moe_route(params, spec, xr)
    tokens = _window(spec, xr)[0]
    dt = x.dtype
    el = params["w_in"].shape[0]                          # the rank's experts
    first = 0 if sh is None else sh.index * el
    sel = one_hot(r.topi - first, el).to(dt)              # (ng, g, k, el)
    # a dropped pair's slot row is zero (the extra class is cut off), as
    # the reference's one_hot(-1, cap)
    slot = one_hot(torch.where(r.keep, r.pos, r.cap),
                   r.cap + 1)[..., :r.cap].to(dt)        # (ng, g, k, cap)
    dispatch = torch.einsum("ngke,ngkc->ngec", sel, slot)
    combine = torch.einsum("ngke,ngkc->ngec",
                           sel * r.topv.to(dt)[..., None], slot)
    xe = dot("ngd,ngec->encd", tokens, dispatch, dt)     # expert buffers
    h = dot("encd,edf->encf", xe, params["w_in"], dt)
    gp = dot("encd,edf->encf", xe, params["w_gate"], dt)
    act = F.silu(gp) if spec.ffn_kind == "swiglu" else F.gelu(
        gp, approximate="tanh")
    ye = dot("encf,efd->encd", act * h, params["w_out"], dt)
    if sh is None:
        y = dot("encd,ngec->ngd", ye, combine, dt)
    else:
        y = pshard.leave(dot("encd,ngec->ngd", ye, combine, F32), sh,
                         "experts").to(dt)
    y = y.reshape(-1, x.shape[-1])[r.lo:r.lo + r.tokens].reshape(x.shape)
    if spec.n_shared:
        y = y + ffn_forward(params["shared"], spec.shared_spec(), x,
                            "shared")
    return y
