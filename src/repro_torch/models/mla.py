"""Multi-head Latent Attention (MLA, DeepSeek-V2 [arXiv:2405.04434]), the
reference's ``src/repro/models/mla.py`` in PyTorch.

KV is compressed into a per-token latent c_kv ∈ R^r (r = kv_lora_rank)
plus a rotary key k_pe ∈ R^{d_rope} shared by the heads; the heads' keys
and values are up-projected from the latent. Training and prefill use the
expanded form (:func:`mla_forward`, the port's chunked attention with
q/k width d_nope + d_rope and value width d_v); decode uses the *absorbed*
form (:func:`mla_decode`): q_nope goes through W_uk into latent space
once, and the scores are taken against the cached latents, so the cache
is (B, S, r) and (B, S, d_rope).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from .. import pshard
from ..pshard import P
from .layers import (F32, NEG_INF, chunked_attention, combine_seq, dot, normal,
                     rope)


@dataclasses.dataclass(frozen=True)
class MlaSpec:
    d_model: int
    n_heads: int
    kv_lora_rank: int = 512
    d_nope: int = 128            # per-head non-rotary q/k dim
    d_rope: int = 64             # shared rotary dim
    d_v: int = 128               # per-head value dim
    rope_theta: float = 10000.0


class Mla(nn.Module):
    """The parameters of one MLA mixer (the reference's ``mla_init``):
    wq (d, H, d_nope + d_rope), w_dkv (d, r + d_rope), kv_norm (r,),
    w_uk (r, H, d_nope), w_uv (r, H, d_v), wo (H, d_v, d)."""

    SPECS = {"wq": P("embed", "heads", None), "w_dkv": P("embed", None),
             "kv_norm": P(None), "w_uk": P("lora", "heads", None),
             "w_uv": P("lora", "heads", None), "wo": P("heads", None, "embed")}
    # as layers.Attention.SPLIT: ``w_dkv`` and ``kv_norm`` are read inside
    SPLIT = pshard.Split("wq", 1)

    def __init__(self, spec: MlaSpec, gen: torch.Generator, dtype=F32):
        super().__init__()
        d, h, r = spec.d_model, spec.n_heads, spec.kv_lora_rank
        sd, sr = 1 / math.sqrt(d), 1 / math.sqrt(r)
        self.wq = nn.Parameter(normal(gen, (d, h, spec.d_nope + spec.d_rope),
                                      sd, dtype))
        self.w_dkv = nn.Parameter(normal(gen, (d, r + spec.d_rope), sd,
                                         dtype))
        self.kv_norm = nn.Parameter(torch.ones((r,), dtype=dtype,
                                               device=gen.device))
        self.w_uk = nn.Parameter(normal(gen, (r, h, spec.d_nope), sr, dtype))
        self.w_uv = nn.Parameter(normal(gen, (r, h, spec.d_v), sr, dtype))
        self.wo = nn.Parameter(normal(gen, (h, spec.d_v, d),
                                      1 / math.sqrt(h * spec.d_v), dtype))


def _latents(params, spec: MlaSpec, x, positions):
    """x → (c_kv RMS-normalised in f32 (eps 1e-6) times ``kv_norm``,
    k_pe rotated): (B, S, r) and (B, S, d_rope) in x.dtype."""
    ckv = dot("bsd,dr->bsr", x, params["w_dkv"], x.dtype)
    c, kpe = ckv[..., :spec.kv_lora_rank], ckv[..., spec.kv_lora_rank:]
    cf = c.to(F32)
    cf = cf * torch.rsqrt(torch.mean(cf * cf, dim=-1, keepdim=True) + 1e-6)
    c = (cf * params["kv_norm"].to(F32)).to(x.dtype)
    kpe = rope(kpe[:, :, None, :], positions, spec.rope_theta)[:, :, 0]
    return c, kpe


def _queries(params, spec: MlaSpec, x, positions):
    """x → (q_nope, rotated q_pe): (B, H, S, d_nope), (B, H, S, d_rope)."""
    q = dot("bsd,dhk->bhsk", x, params["wq"], x.dtype)
    q_nope, q_pe = q[..., :spec.d_nope], q[..., spec.d_nope:]
    # rope takes (..., S, H, D): rotate in (B, S, H, D) and back
    q_pe = rope(q_pe.transpose(1, 2), positions,
                spec.rope_theta).transpose(1, 2)
    return q_nope, q_pe


def head_split(params, spec: MlaSpec) -> "pshard.ModelShard | None":
    """The "model" axis where the heads are cut over it (the rank holds
    ``wq.shape[1]`` of them, block ``index``), or None where they are
    whole (the rules leave them replicated, or there is no model axis)."""
    if params["wq"].shape[1] == spec.n_heads:
        return None
    return pshard.model_shard()


def mla_cache_cut(seq: int) -> str:
    """The layout of an MLA cache of ``seq`` positions on this rank's
    model axis: ``"seq"`` where its positions are cut over "model", else
    ``"whole"``, as :func:`repro_torch.pshard.resolve_spec` resolves the
    reference's cache spec ``P("batch", "tensor", None)``."""
    sh = pshard.model_shard()
    if sh is None or seq % sh.count:
        return "whole"
    return "seq"


def mla_forward(params, spec: MlaSpec, x, positions, *, q_chunk=1024,
                k_chunk=1024, cache: str = "whole"):
    """Training / prefill form: expand the heads' k, v from the latent and
    run chunked causal attention (scale 1/sqrt(d_nope + d_rope), q's
    width). Returns (out (B, S, d), (c_kv, k_pe)), the latter prefill's
    cache in the layout ``cache`` (:func:`mla_cache_cut`): the rank's
    positions where ``"seq"``.

    With the heads cut over "model" (:func:`head_split`) every rank
    computes the latents (``w_dkv`` and ``kv_norm`` are replicated) and
    its own heads inside a split region: q, k_nope and v from its blocks
    of ``wq``, ``w_uk`` and ``w_uv``, the shared k_pe broadcast to them,
    and a row-parallel ``wo`` whose f32 partial is summed over "model".
    The replicated leaves' gradients are then each rank's part."""
    sh = head_split(params, spec)
    if sh is not None:
        x = pshard.enter(x, sh, "mla")
    c, kpe = _latents(params, spec, x, positions)
    q_nope, q_pe = _queries(params, spec, x, positions)
    k_nope = dot("bsr,rhk->bhsk", c, params["w_uk"], x.dtype)
    v = dot("bsr,rhk->bhsk", c, params["w_uv"], x.dtype)
    # the rotary part onto both q and k (k_pe shared by the heads)
    kpe_h = kpe[:, None].expand(-1, q_nope.shape[1], -1, -1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, kpe_h], dim=-1)
    o = chunked_attention(q, k, v, causal=True, window=None, q_offset=0,
                          q_chunk=q_chunk, k_chunk=k_chunk)
    if sh is None:
        out = dot("bhsk,hkd->bsd", o, params["wo"], x.dtype)
    else:
        out = pshard.leave(dot("bhsk,hkd->bsd", o, params["wo"], F32), sh,
                           "mla").to(x.dtype)
    if cache == "seq":
        first, n = pshard.model_shard().block(c.shape[1])
        c, kpe = c[:, first:first + n], kpe[:, first:first + n]
    return out, (c, kpe)


def mla_decode(params, spec: MlaSpec, x, cache_c, cache_kpe, cache_len,
               cut: str = "whole"):
    """Absorbed-form decode. x (B, 1, d); the rank's cache_c (B, Smax, r)
    and cache_kpe (B, Smax, d_rope) in the layout ``cut``
    (:func:`mla_cache_cut` of the whole cache's Smax), written in place at
    ``cache_len``. The scores are taken in latent space (q_nope absorbed
    through W_uk), the softmax over the whole cache with the finite
    ``NEG_INF`` past ``cache_len``; q_lat and o_lat are rounded to
    x.dtype before their next product, as in the reference. Returns (out,
    cache_c, cache_kpe).

    With the heads cut over "model" the rank absorbs its heads' queries
    and finishes with its heads' ``w_uv`` and a row-parallel ``wo``,
    summed. On a sequence-cut cache (``"seq"``) the rank scores every
    head (q_lat and q_pe gathered over "model" where the heads are cut)
    against its positions, and the softmax's MAX and SUM and the o_lat
    numerators are combined over "model"; only the rank that holds
    position ``cache_len`` writes the new latents."""
    b = x.shape[0]
    t = int(cache_len)
    pos = torch.full((b, 1), t, dtype=torch.int32, device=x.device)
    hs = head_split(params, spec)
    sh = pshard.model_shard()
    if hs is not None:
        x = pshard.enter(x, hs, "mla")
    c_new, kpe_new = _latents(params, spec, x, pos)
    first = sh.index * cache_c.shape[1] if cut == "seq" else 0
    local = t - first
    if 0 <= local < cache_c.shape[1]:
        cache_c[:, local:local + 1] = c_new.to(cache_c.dtype)
        cache_kpe[:, local:local + 1] = kpe_new.to(cache_kpe.dtype)

    q_nope, q_pe = _queries(params, spec, x, pos)
    q_lat = dot("bhsk,rhk->bhsr", q_nope, params["w_uk"], x.dtype)
    scale = 1.0 / math.sqrt(spec.d_nope + spec.d_rope)
    valid = first + torch.arange(cache_c.shape[1], device=x.device) <= t
    if cut == "seq":
        o_lat = _decode_seq(q_lat, q_pe, cache_c, cache_kpe, valid, scale,
                            hs, sh)
    else:
        cc = cache_c.to(F32)
        pattn = torch.softmax(_scores(q_lat, q_pe, cc, cache_kpe, valid,
                                      scale), dim=-1)
        o_lat = torch.einsum("bhst,btr->bhsr", pattn, cc).to(x.dtype)
    o = dot("bhsr,rhk->bhsk", o_lat, params["w_uv"], x.dtype)
    if hs is None:
        out = dot("bhsk,hkd->bsd", o, params["wo"], x.dtype)
    else:
        out = pshard.leave(dot("bhsk,hkd->bsd", o, params["wo"], F32), hs,
                           "mla").to(x.dtype)
    return out, cache_c, cache_kpe


def _scores(q_lat, q_pe, cc, cache_kpe, valid, scale):
    """The absorbed scores (B, H, 1, T) in f32 of q_lat against the f32
    latents ``cc`` and q_pe against ``cache_kpe``, ``NEG_INF`` where not
    ``valid``."""
    s = (torch.einsum("bhsr,btr->bhst", q_lat.to(F32), cc)
         + torch.einsum("bhsk,btk->bhst", q_pe.to(F32),
                        cache_kpe.to(F32))) * scale
    return torch.where(valid[None, None, None], s, NEG_INF)


def _decode_seq(q_lat, q_pe, cache_c, cache_kpe, valid, scale, hs, sh):
    """Absorbed decode attention over a sequence-cut latent cache: every
    head (q_lat and q_pe gathered over "model" where the rank holds some)
    against the rank's positions, the softmax's pieces combined over
    "model" → the rank's heads' o_lat (B, h, 1, r) in q_lat's dtype."""
    dt, h = q_lat.dtype, q_lat.shape[1]
    if hs is not None:
        q = pshard.all_gather_dim(torch.cat([q_lat, q_pe], dim=-1), sh, 1,
                                  "decode_q")
        q_lat, q_pe = q[..., :q_lat.shape[-1]], q[..., q_lat.shape[-1]:]
    cc = cache_c.to(F32)
    s = _scores(q_lat, q_pe, cc, cache_kpe, valid, scale)
    o_lat = combine_seq(s, "bhst,btr->bhsr", cc, sh, dt)
    if hs is not None:
        o_lat = o_lat[:, hs.index * h:(hs.index + 1) * h]
    return o_lat
