"""State-space and recurrent mixers: Mamba2 (chunked SSD), mLSTM and
sLSTM, the reference's ``src/repro/models/ssm.py`` in PyTorch.

Mamba2 and mLSTM share one core, :func:`ssd_chunked`: the linear
recurrence

    h_t = exp(a_t)·h_{t-1} + k_t ⊗ v_t,      y_t = qᵀ_t·h_t

evaluated in chunks: a masked attention-like product inside each chunk
plus the state carried between chunks.

  * Mamba2: k=B, q=C, v=x·dt, a=dt·A   (+ D skip, conv1d, gated RMSNorm)
  * mLSTM:  k=k, q=q, v=v·i, a=log f   (+ max-stabiliser, normaliser as an
    extra value channel)
  * sLSTM:  a scalar-memory recurrence with block-diagonal recurrent
    weights, run step by step over time.

The reference scans over chunks (``lax.scan``, each chunk
checkpointed). The port computes the intra-chunk tiles and the chunk
state summaries of all chunks in one batched pass and loops only over
the carry; the block's checkpoint (``ArchConfig.remat``) bounds what
backward keeps. The sLSTM recurrence is a Python loop over time (the
reference's two-level checkpointed scan is a memory device, which the
block's checkpoint replaces). Products follow the reference's casts
through :func:`layers.dot`; the carried states are f32.

**Heads over "model"** (:mod:`repro_torch.pshard`'s split regions).
Mamba2 and mLSTM compute their own heads on each model rank where the
rules cut the heads (each block's ``SPLIT``), as the reference's
``("batch", None, "heads")`` constraints lay out their activations:
the rank reads its pieces of the concatenated projections, its heads of
the per-head leaves, and sums the gated norm's sum of squares and the
row-parallel out-projection over "model". The sLSTM recurrence stays
whole (see :class:`Slstm`). A recurrent state leaves and enters the
compute in the compute's layout (:func:`mamba2_state_layouts`,
:func:`mlstm_state_layouts`); :mod:`.model` moves it to and from the
cache's.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import pshard
from ..pshard import P, Pieces
from .layers import F32, dot, normal


def _weak_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` with the Python float taken in x's dtype, as jnp takes a
    weakly typed scalar (a bf16 x divides by c rounded to bf16)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Chunked SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(v, k, q, log_decay, *, chunk: int = 128, h0=None):
    """Chunked linear-recurrence scan (the reference's ``ssd_chunked``).

    v: (B,S,H,Pv) values; k, q: (B,S,H,N) write and read keys;
    log_decay: (B,S,H) per-step log decay (≤ 0); h0: (B,H,N,Pv) f32 or
    None. Returns (y (B,S,H,Pv) in v.dtype, h_final (B,H,N,Pv) f32).

    Padded steps carry log decay 0 and zero k and v, so they leave the
    state as it is; their outputs are sliced off. Inside a chunk the tile
    is (q_t·k_s)·exp(L_t − L_s) for s ≤ t, L the within-chunk cumsum of
    the log decay; the entries s > t are masked before the exp (the
    reference masks after it: the same values, and no inf reaches the
    backward).
    """
    b, s, h, pv = v.shape
    n = k.shape[-1]
    chunk = min(chunk, s)
    m = -(-s // chunk)
    pad = m * chunk - s

    def pad_t(x, width):
        return F.pad(x.to(F32), (0, 0) * (x.dim() - 2) + (0, pad)).reshape(
            b, m, chunk, *width)

    vp = pad_t(v, (h, pv))                               # (B,M,Q,H,Pv)
    kp = pad_t(k, (h, n))
    qp = pad_t(q, (h, n))
    lcum = torch.cumsum(pad_t(log_decay, (h,)), dim=2)   # L_t, (B,M,Q,H)
    ltot = lcum[:, :, -1]                                # (B,M,H)
    out_dtype = v.dtype

    # intra-chunk: (q_t·k_s)·exp(L_t − L_s) for s ≤ t, every chunk at once
    lt = lcum.transpose(2, 3)                            # (B,M,H,Q)
    tril = torch.ones(chunk, chunk, dtype=torch.bool, device=v.device).tril()
    dmat = torch.exp((lt[..., :, None] - lt[..., None, :]).masked_fill(
        ~tril, float("-inf")))
    sqk = torch.einsum("bmthn,bmshn->bmhts", qp, kp)
    y = torch.einsum("bmhts,bmshp->bmthp", sqk * dmat, vp)
    # each chunk's state summary, then the carry over chunks in order
    w = torch.exp(ltot[:, :, None, :] - lcum)            # decay s → chunk end
    st = torch.einsum("bmshn,bmshp->bmhnp", kp * w[..., None], vp)
    hprev = (torch.zeros((b, h, n, pv), dtype=F32, device=v.device)
             if h0 is None else h0.to(F32))
    decay = torch.exp(ltot)[..., None, None]             # (B,M,H,1,1)
    starts = []
    for i in range(m):
        starts.append(hprev)
        hprev = hprev * decay[:, i] + st[:, i]
    # inter-chunk: each chunk reads the state carried into it
    y = y + torch.einsum("bmthn,bmhnp->bmthp", qp * torch.exp(lcum)[..., None],
                         torch.stack(starts, dim=1))
    return y.to(out_dtype).reshape(b, m * chunk, h, pv)[:, :s], hprev


def ssd_decode_step(hprev, v, k, q, log_decay):
    """Single-token state update: h ← e^a·h + k⊗v; y = q·h.

    hprev: (B,H,N,Pv) f32; v: (B,H,Pv); k, q: (B,H,N); log_decay: (B,H).
    Returns (y in v.dtype, h f32)."""
    hnew = (hprev * torch.exp(log_decay.to(F32))[:, :, None, None]
            + torch.einsum("bhn,bhp->bhnp", k.to(F32), v.to(F32)))
    y = torch.einsum("bhn,bhnp->bhp", q.to(F32), hnew)
    return y.to(v.dtype), hnew


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (the Mamba stem)
# ---------------------------------------------------------------------------

def causal_conv1d(x, w, state=None):
    """x: (B,S,C), w: (K,C) depthwise; state: (B,K−1,C) or None (zeros).
    Returns (y in x.dtype, new state (B,K−1,C) in x.dtype). The K taps
    are multiplied and summed in x's dtype in order, as the reference's
    ``sum`` of products."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, 0:s] * w[0][None, None]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i][None, None]
    return y.to(x.dtype), (xp[:, -(k - 1):] if k > 1 else None)


def _gated_rmsnorm(x, z, scale, sh=None, width: int | None = None):
    """RMSNorm of x·silu(z) over its last dim. With ``sh`` the rank
    holds its block of a width of ``width`` channels, and the sum of
    squares is summed over "model" (:func:`repro_torch.pshard.model_sum`)
    so that every rank divides by the whole's."""
    xf = x.to(F32) * F.silu(z.to(F32))
    if sh is None:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        var = pshard.model_sum(torch.sum(xf * xf, dim=-1, keepdim=True), sh,
                               "norm_ss") / width
    return (xf * torch.rsqrt(var + 1e-6) * scale.to(F32)).to(x.dtype)


def _heads(sh, n: int) -> slice:
    """The rank's ``n`` heads (all of them without ``sh``)."""
    return slice(0, n) if sh is None else slice(sh.index * n,
                                                (sh.index + 1) * n)


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mamba2Spec:
    d_model: int
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_k: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def _w_in_pieces(spec: Mamba2Spec) -> Pieces:
    """The last dim of ``w_in`` [z | x | B | C | dt] (``conv_w`` and the
    conv state hold its [x | B | C] alone): z, x and dt are laid out head
    by head, B and C are read by every head (``n_groups`` of them)."""
    di, gn = spec.d_inner, spec.n_groups * spec.d_state
    return Pieces(-1, (di, di, 2 * gn, spec.n_heads), (True, True, False,
                                                        True))


def _conv_pieces(spec: Mamba2Spec) -> Pieces:
    di, gn = spec.d_inner, spec.n_groups * spec.d_state
    return Pieces(-1, (di, 2 * gn), (True, False))


class Mamba2(nn.Module):
    """The parameters of one Mamba2 mixer (the reference's
    ``mamba2_init``): w_in (d, 2·d_inner + 2·g·N + H) for [z, x, B, C,
    dt], conv_w (K, d_inner + 2·g·N), a_log, dt_bias and d_skip (H,) in
    f32 whatever ``dtype`` is, norm_scale (d_inner,), w_out (d_inner, d).

    Its split region (``SPLIT``): where ``norm_scale`` is cut over
    "model" in whole heads (the rules cut "heads" and H divides the
    axis), a rank computes its heads. ``w_in`` and ``conv_w`` are then
    read as pieces (the rank's z, x and dt columns, and every B and C
    column: the storage block of a concatenated leaf is not a head's
    columns), ``norm_scale`` and ``w_out`` are its blocks, and
    ``a_log``, ``dt_bias`` and ``d_skip`` are read at its heads."""

    SPECS = {"w_in": P("embed", "heads"), "conv_w": P(None, "heads"),
             "a_log": P(None), "dt_bias": P(None), "d_skip": P(None),
             "norm_scale": P("heads"), "w_out": P("heads", "embed")}

    def __init__(self, spec: Mamba2Spec, gen: torch.Generator, dtype=F32):
        super().__init__()
        d, di, n, hh = spec.d_model, spec.d_inner, spec.d_state, spec.n_heads
        gn, dev = spec.n_groups * n, gen.device
        self.w_in = nn.Parameter(normal(gen, (d, 2 * di + 2 * gn + hh),
                                        1 / math.sqrt(d), dtype))
        self.conv_w = nn.Parameter(normal(gen, (spec.conv_k, di + 2 * gn),
                                          0.5, dtype))
        self.a_log = nn.Parameter(torch.zeros(hh, dtype=F32, device=dev))
        self.dt_bias = nn.Parameter(torch.zeros(hh, dtype=F32, device=dev))
        self.d_skip = nn.Parameter(torch.ones(hh, dtype=F32, device=dev))
        self.norm_scale = nn.Parameter(torch.ones(di, dtype=dtype,
                                                  device=dev))
        self.w_out = nn.Parameter(normal(gen, (di, d), 1 / math.sqrt(di),
                                         dtype))
        self.SPLIT = pshard.Split("norm_scale", 0, unit=spec.head_dim,
                                  pieces={"w_in": _w_in_pieces(spec),
                                          "conv_w": _conv_pieces(spec)})


def mamba2_split(params, spec: Mamba2Spec) -> "pshard.ModelShard | None":
    """The "model" axis where the rank holds its heads' block of
    ``norm_scale`` (and its pieces of ``w_in`` and ``conv_w``), or None
    where the leaves are whole."""
    if params["norm_scale"].shape[0] == spec.d_inner:
        return None
    return pshard.model_shard()


def mamba2_state_layouts(params, spec: Mamba2Spec) -> dict:
    """{"ssm", "conv": the layout the compute reads and writes the state
    in}: the rank's heads of ``ssm`` and its pieces of ``conv`` where the
    heads are split (:class:`repro_torch.pshard.Pieces`), else None
    (whole)."""
    if mamba2_split(params, spec) is None:
        return {"ssm": None, "conv": None}
    return {"ssm": Pieces(1, (spec.n_heads,), (True,)),
            "conv": _conv_pieces(spec)}


def _mamba2_mix(params, spec: Mamba2Spec, x, conv0, sh):
    """The projections before the scan: → (z, x heads, B, C, dt f32,
    log decay, conv state), over the rank's heads (``sh``; all of them
    without). x: (B,S,d)."""
    b, s, _ = x.shape
    di = params["norm_scale"].shape[0]                   # the rank's channels
    hh, gn = di // spec.head_dim, spec.n_groups * spec.d_state
    rep, heads = spec.n_heads // spec.n_groups, _heads(sh, hh)
    zxbcdt = dot("bsd,de->bse", x, params["w_in"], x.dtype)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * gn, hh], dim=-1)
    conv_out, conv_state = causal_conv1d(xbc, params["conv_w"], conv0)
    conv_out = F.silu(conv_out.to(F32)).to(x.dtype)
    xc, bc, cc = torch.split(conv_out, [di, gn, gn], dim=-1)
    dt = F.softplus(dt.to(F32) + params["dt_bias"][heads])         # (B,S,H)
    log_decay = dt * -torch.exp(params["a_log"][heads])
    xh = xc.reshape(b, s, hh, spec.head_dim)
    kb = bc.reshape(b, s, spec.n_groups, spec.d_state).repeat_interleave(
        rep, dim=2)[:, :, heads]
    qc = cc.reshape(b, s, spec.n_groups, spec.d_state).repeat_interleave(
        rep, dim=2)[:, :, heads]
    return z, xh, kb, qc, dt, log_decay, conv_state


def _mamba2_out(params, spec: Mamba2Spec, x, y, xh, z, sh):
    y = y + xh * params["d_skip"][_heads(sh, xh.shape[2])][:, None].to(
        x.dtype)
    y = y.reshape(*x.shape[:2], params["norm_scale"].shape[0])
    y = _gated_rmsnorm(y, z, params["norm_scale"], sh, spec.d_inner)
    if sh is None:
        return dot("bse,ed->bsd", y, params["w_out"], x.dtype)
    return pshard.leave(dot("bse,ed->bsd", y, params["w_out"], F32), sh,
                        "mamba").to(x.dtype)


def mamba2_forward(params, spec: Mamba2Spec, x, h0=None, conv0=None):
    """x: (B,S,d) → (y, (ssm state (B,H,N,P) f32, conv state)), the
    states in :func:`mamba2_state_layouts`' layouts (``h0`` and ``conv0``
    too). With the heads split (:func:`mamba2_split`) the rank computes
    its heads inside a split region: its z, x and dt columns and every
    B and C column projected, its x channels and B and C convolved, the
    scan over its heads, the gated norm over the whole width, and a
    row-parallel ``w_out`` whose f32 partial is summed over "model"."""
    sh = mamba2_split(params, spec)
    if sh is not None:
        x = pshard.enter(x, sh, "mamba")
    z, xh, kb, qc, dt, log_decay, conv_state = _mamba2_mix(params, spec, x,
                                                           conv0, sh)
    v = xh * dt[..., None].to(x.dtype)
    y, hfin = ssd_chunked(v, kb, qc, log_decay, chunk=spec.chunk, h0=h0)
    return _mamba2_out(params, spec, x, y, xh, z, sh), (hfin, conv_state)


def mamba2_decode(params, spec: Mamba2Spec, x, state):
    """Single-token decode. x: (B,1,d); state = (h (B,H,N,P), conv
    (B,K−1,C)), in :func:`mamba2_state_layouts`' layouts."""
    h0, conv0 = state
    sh = mamba2_split(params, spec)
    if sh is not None:
        x = pshard.enter(x, sh, "mamba")
    z, xh, kb, qc, dt, log_decay, conv_state = _mamba2_mix(params, spec, x,
                                                           conv0, sh)
    v = xh[:, 0] * dt[:, 0, :, None].to(x.dtype)
    y, hnew = ssd_decode_step(h0, v, kb[:, 0], qc[:, 0], log_decay[:, 0])
    return (_mamba2_out(params, spec, x, y[:, None], xh, z, sh),
            (hnew, conv_state))


# ---------------------------------------------------------------------------
# mLSTM (xLSTM): matrix memory with exponential gating
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MlstmSpec:
    d_model: int
    n_heads: int = 4
    expand: int = 2
    qk_factor: float = 0.5          # d_qk = qk_factor · d_v
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def d_v(self) -> int:
        return self.d_inner // self.n_heads

    @property
    def d_qk(self) -> int:
        return int(self.d_v * self.qk_factor)


class Mlstm(nn.Module):
    """The parameters of one mLSTM mixer (the reference's ``mlstm_init``):
    w_up (d, 2·d_inner) for [main, gate], wq/wk (d_inner, H, d_qk), wv
    (d_inner, H, d_v), w_if (d_inner, 2H) and f_bias (H,) in f32 whatever
    ``dtype`` is, norm_scale (d_inner,), w_down (d_inner, d).

    Its split region (``SPLIT``): where ``wq``'s heads are cut over
    "model", a rank computes its heads. Every head's q, k and v contract
    the whole main branch, so the rank projects the main half of
    ``w_up`` whole (its gradient a part on each rank) and the gate half's
    columns of its heads; ``w_up`` and ``w_if`` ([i | f], H columns
    each) are read as pieces, ``wq``, ``wk``, ``wv``, ``norm_scale`` and
    ``w_down`` are its blocks, ``f_bias`` is read at its heads."""

    SPECS = {"w_up": P("embed", "heads"), "wq": P(None, "heads", None),
             "wk": P(None, "heads", None), "wv": P(None, "heads", None),
             "w_if": P(None, "heads"), "f_bias": P(None),
             "norm_scale": P("heads"), "w_down": P("heads", "embed")}

    def __init__(self, spec: MlstmSpec, gen: torch.Generator, dtype=F32):
        super().__init__()
        d, di, h = spec.d_model, spec.d_inner, spec.n_heads
        si, dev = 1 / math.sqrt(di), gen.device
        self.w_up = nn.Parameter(normal(gen, (d, 2 * di), 1 / math.sqrt(d),
                                        dtype))
        self.wq = nn.Parameter(normal(gen, (di, h, spec.d_qk), si, dtype))
        self.wk = nn.Parameter(normal(gen, (di, h, spec.d_qk), si, dtype))
        self.wv = nn.Parameter(normal(gen, (di, h, spec.d_v), si, dtype))
        self.w_if = nn.Parameter(normal(gen, (di, 2 * h), 1e-2, F32))
        self.f_bias = nn.Parameter(torch.full((h,), 3.0, dtype=F32,
                                              device=dev))
        self.norm_scale = nn.Parameter(torch.ones(di, dtype=dtype,
                                                  device=dev))
        self.w_down = nn.Parameter(normal(gen, (di, d), si, dtype))
        self.SPLIT = pshard.Split("wq", 1, pieces={
            "w_up": Pieces(-1, (di, di), (False, True)),
            "w_if": Pieces(-1, (h, h), (True, True))})


def mlstm_split(params, spec: MlstmSpec) -> "pshard.ModelShard | None":
    """The "model" axis where the rank holds its block of the heads, or
    None where they are whole."""
    if params["wq"].shape[1] == spec.n_heads:
        return None
    return pshard.model_shard()


def mlstm_state_layouts(params, spec: MlstmSpec) -> dict:
    """{"h": the layout the compute reads and writes the state in}: the
    rank's heads where they are split, else None (whole)."""
    if mlstm_split(params, spec) is None:
        return {"h": None}
    return {"h": Pieces(1, (spec.n_heads,), (True,))}


def _mlstm_up(params, spec: MlstmSpec, x):
    """The up-projection → (xm, the whole main branch; z, the rank's
    gate columns)."""
    up = dot("bsd,de->bse", x, params["w_up"], x.dtype)
    return torch.split(up, [spec.d_inner, up.shape[-1] - spec.d_inner],
                       dim=-1)


def _mlstm_gates(params, xm, sh):
    """Log-space exponential gating in f32 → (log ĩ, log f), (B,S,h) over
    the rank's h heads (``w_if``'s pieces [i | f])."""
    gi = dot("bsd,dg->bsg", xm.to(F32), params["w_if"], F32)
    h = params["w_if"].shape[-1] // 2
    return gi[..., :h], F.logsigmoid(gi[..., h:]
                                     + params["f_bias"][_heads(sh, h)])


def _mlstm_out(params, spec: MlstmSpec, x, y, z, sh):
    """Normalise by the normaliser channel, gated RMSNorm, down-project
    (row-parallel where the heads are split)."""
    dv = spec.d_v
    yv, yn = y[..., :dv].to(F32), y[..., dv:].to(F32)
    out = (yv / torch.clamp(torch.abs(yn), min=1e-6)).reshape(
        *x.shape[:2], params["norm_scale"].shape[0])
    out = _gated_rmsnorm(out.to(x.dtype), z, params["norm_scale"], sh,
                         spec.d_inner)
    if sh is None:
        return dot("bse,ed->bsd", out, params["w_down"], x.dtype)
    return pshard.leave(dot("bse,ed->bsd", out, params["w_down"], F32), sh,
                        "mlstm").to(x.dtype)


def mlstm_forward(params, spec: MlstmSpec, x, h0=None):
    """x: (B,S,d) → (y, h_final (B,H,d_qk,d_v+1) f32; ``h0`` and the
    state in :func:`mlstm_state_layouts`' layout). Chunked parallel
    mLSTM: the input gate folds into v as v·exp(ĩ − m̂), m̂ the per-head
    max of ĩ over the whole sequence, detached (the reference's
    ``stop_gradient``); the normaliser is the value channel of ones. A
    prefill's state is therefore scaled by exp(−m̂), which a decode step,
    adding unscaled terms, does not undo: the reference's behaviour,
    reproduced. With the heads split (:func:`mlstm_split`) the rank
    computes its heads inside a split region (see :class:`Mlstm`)."""
    sh = mlstm_split(params, spec)
    if sh is not None:
        x = pshard.enter(x, sh, "mlstm")
    xm, z = _mlstm_up(params, spec, x)
    q = dot("bse,ehk->bshk", xm, params["wq"], x.dtype)
    k = _weak_div(dot("bse,ehk->bshk", xm, params["wk"], x.dtype),
                  math.sqrt(spec.d_qk))
    v = dot("bse,ehk->bshk", xm, params["wv"], x.dtype)
    log_i, log_f = _mlstm_gates(params, xm, sh)
    mstab = torch.amax(log_i, dim=1, keepdim=True).detach()
    gate = torch.exp(log_i - mstab).to(x.dtype)
    vaug = torch.cat([v * gate[..., None], gate[..., None]], dim=-1)
    y, hfin = ssd_chunked(vaug, k, q, log_f, chunk=spec.chunk, h0=h0)
    return _mlstm_out(params, spec, x, y, z, sh), hfin


def mlstm_decode(params, spec: MlstmSpec, x, hstate):
    """Single-token mLSTM step. x: (B,1,d); hstate: (B,H,d_qk,d_v+1) f32,
    in :func:`mlstm_state_layouts`' layout. q, k and v stay f32 here, as
    in the reference."""
    sh = mlstm_split(params, spec)
    if sh is not None:
        x = pshard.enter(x, sh, "mlstm")
    xm, z = _mlstm_up(params, spec, x)
    q = dot("bse,ehk->bshk", xm, params["wq"], F32)[:, 0]
    k = dot("bse,ehk->bshk", xm, params["wk"], F32)[:, 0] / math.sqrt(
        spec.d_qk)
    v = dot("bse,ehk->bshk", xm, params["wv"], F32)[:, 0]
    log_i, log_f = _mlstm_gates(params, xm, sh)
    ei = torch.exp(log_i[:, 0])[..., None]                 # (B,H,1)
    y, hnew = ssd_decode_step(hstate, torch.cat([v * ei, ei], dim=-1), k, q,
                              log_f[:, 0])
    return _mlstm_out(params, spec, x, y[:, None], z, sh), hnew


# ---------------------------------------------------------------------------
# sLSTM (xLSTM): scalar memory, a true recurrence over time
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SlstmSpec:
    d_model: int
    n_heads: int = 4
    proj_factor: float = 4.0 / 3.0

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_up(self) -> int:
        return int(self.d_model * self.proj_factor)


class Slstm(nn.Module):
    """The parameters of one sLSTM mixer (the reference's ``slstm_init``):
    w_gates (d, 4d), r_gates (H, d_head, 4·d_head) block-diagonal
    recurrent weights, b_gates (4d,) in f32 whatever ``dtype`` is,
    norm_scale (d,), w_up (d, 2·d_up), w_down (d_up, d).

    Its compute stays whole on every model rank (``SPLIT = None``: the
    sharded steps gather its leaves whole). The cell splits the flat
    (B, 4d) gate vector into i, f, z and o with ``chunk(·, 4)``, and the
    vector is laid out head by head, so each state unit's four gates
    come from different heads' recurrences: a head split would gather h
    over "model" at every time step (4 096 of them in train_4k). Its
    ``w_up`` and ``w_down`` do not divide 16 model ranks at full width
    (2 730 and 1 365 columns)."""

    SPLIT = None

    SPECS = {"w_gates": P("embed", "heads"), "r_gates": P("heads", None, None),
             "b_gates": P(None), "norm_scale": P(None),
             "w_up": P("embed", "ffn"), "w_down": P("ffn", "embed")}

    def __init__(self, spec: SlstmSpec, gen: torch.Generator, dtype=F32):
        super().__init__()
        d, h, dh, du = spec.d_model, spec.n_heads, spec.d_head, spec.d_up
        dev = gen.device
        self.w_gates = nn.Parameter(normal(gen, (d, 4 * d), 1 / math.sqrt(d),
                                           dtype))
        self.r_gates = nn.Parameter(normal(gen, (h, dh, 4 * dh),
                                           1 / math.sqrt(dh), dtype))
        self.b_gates = nn.Parameter(torch.zeros(4 * d, dtype=F32,
                                                device=dev))
        self.norm_scale = nn.Parameter(torch.ones(d, dtype=dtype,
                                                  device=dev))
        self.w_up = nn.Parameter(normal(gen, (d, 2 * du), 1 / math.sqrt(d),
                                        dtype))
        self.w_down = nn.Parameter(normal(gen, (du, d), 1 / math.sqrt(du),
                                          dtype))


def slstm_cell(r_gates, b_gates, gx, state):
    """One timestep. r_gates: (H, d_head, 4·d_head) f32; b_gates: (4d,);
    gx: (B, 4d) f32, the step's input contribution; state = (h, c, n, m),
    each (B, d) f32. Stabilised exponential gating."""
    h, c, n, m = state
    hh, dh, g4 = r_gates.shape
    b = h.shape[0]
    # the block-diagonal recurrence "bhk,hkg->bhg", flattened to (B, 4d)
    rec = torch.bmm(h.reshape(b, hh, dh).transpose(0, 1), r_gates)
    g = gx + rec.transpose(0, 1).reshape(b, hh * g4) + b_gates
    gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
    fm = gf + m
    m_new = torch.maximum(fm, gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(fm - m_new)
    c_new = f * c + i * torch.tanh(gz)
    n_new = f * n + i
    h_new = torch.sigmoid(go) * c_new / torch.clamp(n_new, min=1e-6)
    return h_new, c_new, n_new, m_new


def slstm_forward(params, spec: SlstmSpec, x, state0=None):
    """x: (B,S,d) → (y, final state (h, c, n, m) f32). A sequential loop
    over S, then the post-cell RMS norm and the gated up/down projection
    (proj_factor 4/3, tanh GELU)."""
    b, s, d = x.shape
    gates_x = dot("bsd,dg->bsg", x, params["w_gates"], x.dtype).to(F32)
    if state0 is None:
        z = torch.zeros((b, d), dtype=F32, device=x.device)
        state0 = (z, z, z, z)
    r_gates = params["r_gates"].to(F32)
    state, hs = state0, []
    for t in range(s):
        state = slstm_cell(r_gates, params["b_gates"], gates_x[:, t], state)
        hs.append(state[0])
    yf = torch.stack(hs, dim=1).to(x.dtype).to(F32)
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6)
    y = (yf * params["norm_scale"].to(F32)).to(x.dtype)
    up = dot("bsd,de->bse", y, params["w_up"], x.dtype)
    a, g = torch.chunk(up, 2, dim=-1)
    y = F.gelu(g.to(F32), approximate="tanh").to(x.dtype) * a
    return dot("bse,ed->bsd", y, params["w_down"], x.dtype), state


def slstm_decode(params, spec: SlstmSpec, x, state):
    """One step of :func:`slstm_forward` from ``state``."""
    return slstm_forward(params, spec, x, state)
