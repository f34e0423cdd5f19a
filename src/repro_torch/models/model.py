"""The LM: block programs → per-layer modules, the reference's
``src/repro/models/model.py`` in PyTorch.

An architecture is an :class:`ArchConfig` holding a *block program*: a
tuple of :class:`Segment`\\ s, each ``(repeat, blocks)``. The reference
stacks a segment's parameters on a leading ``repeat`` axis and scans them;
the port keeps one ``nn.ModuleList`` of layers per segment and loops over
it, each block checkpointed (``torch.utils.checkpoint``, non-reentrant)
where ``cfg.remat``. :func:`repro_torch.convert.lm_params_from_reference`
and ``lm_params_to_reference`` map between the two layouts.

Three input frontends (tokens, audio frames, VLM patch embeddings), tied
or untied LM heads, chunked attention, and a **chunked cross-entropy**
(:func:`chunked_xent`): sequence chunks of ``loss_chunk``, each
checkpointed, so the (B, S, vocab) logits never exist.

The functions take a parameter tree (:func:`repro_torch.models.layers.
param_tree` of an :class:`LM`, or that tree cast to the compute dtype by
the train step), as the reference's take ``params``. :class:`LM` owns
the parameters and wraps the functions.

A block's mixer is ``attn`` (GQA), ``mla`` (:mod:`.mla`), ``mamba2``,
``mlstm`` or ``slstm`` (:mod:`.ssm`); an attention or MLA block's FFN is
dense or a MoE (:func:`layers.moe_forward`). A ``shared`` block (zamba2)
owns no parameters in its layer: every application reads the one block
``LM.shared`` built from ``cfg.shared_block`` (``params["shared"]``), so
its gradients from every application add into one leaf; decode keeps one
cache per application.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import pshard
from ..core.device import resolve_device
from ..pshard import P
from . import layers as L
from . import mla as M
from . import ssm as S

F32 = torch.float32


# ---------------------------------------------------------------------------
# Config dataclasses
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Block:
    kind: str                          # attn | mla | mamba2 | mlstm | slstm
    attn: L.AttnSpec | None = None
    mla: M.MlaSpec | None = None
    ffn: L.FfnSpec | None = None       # dense FFN (attn/mla blocks)
    moe: L.MoeSpec | None = None       # MoE in place of dense FFN
    mamba: S.Mamba2Spec | None = None
    mlstm: S.MlstmSpec | None = None
    slstm: S.SlstmSpec | None = None
    shared: bool = False               # zamba2: params from the shared group


@dataclasses.dataclass(frozen=True)
class Segment:
    repeat: int
    blocks: tuple[Block, ...]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                        # dense | moe | vlm | hybrid | audio | ssm
    vocab: int
    d_model: int
    segments: tuple[Segment, ...]
    frontend: str = "tokens"           # tokens | frames | vlm
    encoder_only: bool = False
    tie_embeddings: bool = True
    d_frame: int = 512                 # audio stub frame-embedding dim
    d_patch: int = 1024                # vlm stub patch-embedding dim
    n_img_tokens: int = 256
    shared_block: Block | None = None
    q_chunk: int = 512
    k_chunk: int = 1024
    loss_chunk: int = 512
    remat: bool = True
    sub_quadratic: bool = False        # eligible for long_500k

    @property
    def n_layers(self) -> int:
        return sum(seg.repeat * len(seg.blocks) for seg in self.segments)


# ---------------------------------------------------------------------------
# Parameters: one module per block
# ---------------------------------------------------------------------------

class BlockParams(nn.Module):
    """One block's parameters: norm1, mixer, and (with a dense FFN or a
    MoE) norm2 and ffn, under the reference's names."""

    def __init__(self, blk: Block, cfg: ArchConfig, gen: torch.Generator,
                 dtype=F32):
        super().__init__()
        d, dev = cfg.d_model, gen.device
        self.norm1 = L.RMSNorm(d, device=dev, dtype=dtype)
        if blk.kind == "attn":
            self.mixer = L.Attention(blk.attn, gen, dtype)
        elif blk.kind == "mla":
            self.mixer = M.Mla(blk.mla, gen, dtype)
        elif blk.kind == "mamba2":
            self.mixer = S.Mamba2(blk.mamba, gen, dtype)
        elif blk.kind == "mlstm":
            self.mixer = S.Mlstm(blk.mlstm, gen, dtype)
        elif blk.kind == "slstm":
            self.mixer = S.Slstm(blk.slstm, gen, dtype)
        else:
            raise ValueError(blk.kind)
        if blk.ffn is not None or blk.moe is not None:
            self.norm2 = L.RMSNorm(d, device=dev, dtype=dtype)
            self.ffn = (L.Moe(blk.moe, gen, dtype) if blk.moe is not None
                        else L.Ffn(blk.ffn, gen, dtype))


class LM(nn.Module):
    """An LM built from ``cfg``, its weights drawn from ``generator`` (or a
    fresh one seeded with ``seed``) on ``device`` (None: the card;
    ``"meta"``: the parameters' shapes only, no memory).

    Parameters (f32 masters by default), under the reference's names:
    ``embed`` (vocab, d), ``lm_head`` (d, vocab) when untied,
    ``frame_proj``/``patch_proj`` for the frames/vlm frontends,
    ``final_norm.scale``, ``segments[si][layer]["b{bi}"]`` blocks (none
    for a shared block) and, with ``cfg.shared_block``, ``shared``.

    Each parameter's logical sharding spec is its module's ``SPECS``
    entry (:func:`param_specs`)."""

    SPECS = {"embed": P("vocab", "embed"), "lm_head": P("embed", "vocab"),
             "frame_proj": P(None, "embed"), "patch_proj": P(None, "embed")}

    def __init__(self, cfg: ArchConfig, *, seed: int = 0,
                 generator: torch.Generator | None = None, device=None,
                 dtype=F32):
        super().__init__()
        self.cfg = cfg
        if generator is None:
            dev = resolve_device(device)
            if dev.type == "meta":
                generator = L.MetaGenerator()
            else:
                generator = torch.Generator(device=dev)
                generator.manual_seed(seed)
        gen = generator
        dev = gen.device
        d = cfg.d_model
        self.embed = nn.Parameter(L.normal(gen, (cfg.vocab, d), 0.02, dtype))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(L.normal(
                gen, (d, cfg.vocab), 1.0 / math.sqrt(d), dtype))
        if cfg.frontend == "frames":
            self.frame_proj = nn.Parameter(L.normal(
                gen, (cfg.d_frame, d), 1.0 / math.sqrt(cfg.d_frame), dtype))
        if cfg.frontend == "vlm":
            self.patch_proj = nn.Parameter(L.normal(
                gen, (cfg.d_patch, d), 1.0 / math.sqrt(cfg.d_patch), dtype))
        self.final_norm = L.RMSNorm(d, device=dev, dtype=dtype)
        self.segments = nn.ModuleList(
            nn.ModuleList(
                nn.ModuleDict({f"b{bi}": BlockParams(blk, cfg, gen, dtype)
                               for bi, blk in enumerate(seg.blocks)
                               if not blk.shared})
                for _ in range(seg.repeat))
            for seg in cfg.segments)
        if cfg.shared_block is not None:
            self.shared = BlockParams(cfg.shared_block, cfg, gen, dtype)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def tree(self, cast=None):
        """The parameter tree the functions take; ``cast``: the train
        step's compute-dtype cast (:func:`layers.param_tree`)."""
        return L.param_tree(self, cast)

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def specs(self) -> dict:
        """{parameter name: logical spec}, see :func:`param_specs`."""
        return {f"{mn}.{pn}" if mn else pn: type(mod).SPECS[pn]
                for mn, mod in self.named_modules()
                for pn, _ in mod.named_parameters(recurse=False)}

    def forward_loss(self, batch: dict, compute_dtype=torch.bfloat16,
                     params=None):
        return forward_loss(self.tree() if params is None else params,
                            self.cfg, batch, compute_dtype)

    forward = forward_loss

    def prefill(self, batch: dict, compute_dtype=torch.bfloat16,
                params=None):
        return prefill(self.tree() if params is None else params, self.cfg,
                       batch, compute_dtype)

    def decode_step(self, token, caches, cache_len,
                    compute_dtype=torch.bfloat16, params=None):
        return decode_step(self.tree() if params is None else params,
                           self.cfg, token, caches, cache_len, compute_dtype)


def param_specs(cfg: ArchConfig) -> dict:
    """Every parameter's logical spec, {port name: :class:`P`}: the
    reference's ``init_params`` specs (``src/repro/models/model.py:
    241-298``), a stacked segment leaf's without its leading ``None``
    (the port keeps one module per layer). Built on the meta device."""
    return LM(cfg, device="meta").specs()


def holding(cfg: ArchConfig, params: dict) -> LM:
    """An :class:`LM` of ``cfg`` whose parameters are the given tensors
    ({port name: tensor}, every name of the model, any shapes: a rank's
    shards too), each wrapped as an ``nn.Parameter`` sharing its
    storage."""
    model = LM(cfg, device="meta")
    names = {n for n, _ in model.named_parameters()}
    if names != set(params):
        raise KeyError(f"{cfg.name}: missing {sorted(names - set(params))}, "
                       f"unexpected {sorted(set(params) - names)}")
    for name, t in params.items():
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, nn.Parameter(t))
    return model


# ---------------------------------------------------------------------------
# Per-block forward / decode
# ---------------------------------------------------------------------------

def _ffn(p, blk: Block, x):
    """The block's FFN half: x + FFN(norm2(x)), dense or MoE."""
    if "ffn" not in p:
        return x
    h = L.rmsnorm(p["norm2"], x)
    if blk.moe is not None:
        return x + L.moe_forward(p["ffn"], blk.moe, h)
    return x + L.ffn_forward(p["ffn"], blk.ffn, h)


# the sLSTM cache's keys, in the order of the cell's state tuple
SLSTM_STATE = ("h", "c", "n", "m")
_RECURRENT = ("mamba2", "mlstm", "slstm")


def _block_forward(p, blk: Block, cfg: ArchConfig, x, positions,
                   want_cache: bool):
    """Full-sequence block application → (x, cache or None)."""
    h = L.rmsnorm(p["norm1"], x)
    cache = None
    if blk.kind == "mla":
        cut = M.mla_cache_cut(x.shape[1]) if want_cache else "whole"
        mix, (c, kpe) = M.mla_forward(p["mixer"], blk.mla, h, positions,
                                      q_chunk=cfg.q_chunk,
                                      k_chunk=cfg.k_chunk, cache=cut)
        cache = {"c": c, "kpe": kpe}
    elif blk.kind == "mamba2":
        mix, (hf, conv) = S.mamba2_forward(p["mixer"], blk.mamba, h)
        cache = {"ssm": hf, "conv": conv}
    elif blk.kind == "mlstm":
        mix, hf = S.mlstm_forward(p["mixer"], blk.mlstm, h)
        cache = {"h": hf}
    elif blk.kind == "slstm":
        mix, st = S.slstm_forward(p["mixer"], blk.slstm, h)
        cache = dict(zip(SLSTM_STATE, st))
    else:
        cut = (L.attn_cache_cut(blk.attn, x.shape[1]) if want_cache
               else None)
        mix, kv = L.attn_prefill(p["mixer"], blk.attn, h, positions, cut,
                                 q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk)
        if want_cache:
            cache = {"k": kv[0], "v": kv[1]}
    if not want_cache:
        return _ffn(p, blk, x + mix), None
    moves = _state_moves(p["mixer"], blk, cfg, x.shape[0])
    if moves:                           # the compute's layout → the cache's
        cache = {n: _move(t, *moves[n]) for n, t in cache.items()}
    return _ffn(p, blk, x + mix), cache


def _block_decode(p, blk: Block, cfg: ArchConfig, x, cache, cache_len,
                  smax: int | None = None):
    """Single-token decode → (x, cache). Attention and MLA caches are
    written in place (``smax``: the whole cache's positions, which name
    its layout on the model axis; by default the given cache's own); a
    recurrent block returns its new state, read from and written to the
    cache's layout (:func:`_state_moves`)."""
    h = L.rmsnorm(p["norm1"], x)
    moves = _state_moves(p["mixer"], blk, cfg, x.shape[0])
    state = cache
    if moves:
        state = {n: _move(t, *moves[n][::-1]) for n, t in cache.items()}
    if blk.kind == "mla":
        cut = M.mla_cache_cut(cache["c"].shape[1] if smax is None else smax)
        mix, cc, ckpe = M.mla_decode(p["mixer"], blk.mla, h, cache["c"],
                                     cache["kpe"], cache_len, cut)
        cache = {"c": cc, "kpe": ckpe}
    elif blk.kind == "mamba2":
        mix, (hf, conv) = S.mamba2_decode(p["mixer"], blk.mamba, h,
                                          (state["ssm"], state["conv"]))
        cache = {"ssm": hf, "conv": conv}
    elif blk.kind == "mlstm":
        mix, hf = S.mlstm_decode(p["mixer"], blk.mlstm, h, state["h"])
        cache = {"h": hf}
    elif blk.kind == "slstm":
        mix, st = S.slstm_decode(p["mixer"], blk.slstm, h,
                                 tuple(state[k] for k in SLSTM_STATE))
        cache = dict(zip(SLSTM_STATE, st))
    else:
        cut = L.attn_cache_cut(blk.attn, cache["k"].shape[2]
                               if smax is None else smax)
        mix, ck, cv = L.attn_decode(p["mixer"], blk.attn, h, cache["k"],
                                    cache["v"], cache_len, cut)
        cache = {"k": ck, "v": cv}
    if moves:
        cache = {n: _move(t, *moves[n]) for n, t in cache.items()}
    return _ffn(p, blk, x + mix), cache


def _state_moves(mixer, blk: Block, cfg: ArchConfig, rows: int) -> dict:
    """{state: (the compute's layout, the cache's layout)} of a
    recurrent block inside a model context (empty for any other block,
    and outside one), each layout a
    :class:`repro_torch.pshard.Pieces` or None (whole): the compute's
    from the mixer's leaves (:func:`ssm.mamba2_state_layouts`,
    :func:`ssm.mlstm_state_layouts`; sLSTM's whole), the cache's the dim
    that :func:`block_cache_layouts` cuts over "model"."""
    sh = pshard.model_shard()
    if sh is None or blk.kind not in _RECURRENT:
        return {}
    if blk.kind == "mamba2":
        comp = S.mamba2_state_layouts(mixer, blk.mamba)
    elif blk.kind == "mlstm":
        comp = S.mlstm_state_layouts(mixer, blk.mlstm)
    else:
        comp = dict.fromkeys(SLSTM_STATE)
    out = {}
    for n, lay in block_cache_layouts(blk, cfg, sh.mesh, rows, 1).items():
        dims = [d for d in range(1, len(lay.shape))
                if pshard.MODEL_AXIS in lay.dim_axes(d)]
        cut = (pshard.Pieces(dims[0], (lay.shape[dims[0]],), (True,))
               if dims else None)
        out[n] = (comp[n], cut)
    return out


def _move(t, src, dst):
    """A recurrent state from layout ``src`` to ``dst`` (each a
    :class:`repro_torch.pshard.Pieces` or None, whole) on this rank's
    model shard: joined over "model" where ``src`` cuts it, then
    ``dst``'s pieces taken."""
    if src == dst:
        return t
    sh = pshard.model_shard()
    whole = t if src is None else src.join(t, sh, "state")
    return whole if dst is None else dst.take(whole, sh.index, sh.count)


def _block_caches(blk: Block, cfg: ArchConfig, batch: int, smax: int,
                  dtype) -> dict:
    """{cache name: (shape, dtype)} of one block's decode cache."""
    if blk.kind == "attn":
        a = blk.attn
        kv = ((batch, a.n_kv_heads, smax, a.d_head), dtype)
        return {"k": kv, "v": kv}
    if blk.kind == "mla":
        m = blk.mla
        return {"c": ((batch, smax, m.kv_lora_rank), dtype),
                "kpe": ((batch, smax, m.d_rope), dtype)}
    if blk.kind == "mamba2":
        mb = blk.mamba
        return {"ssm": ((batch, mb.n_heads, mb.d_state, mb.head_dim), F32),
                "conv": ((batch, mb.conv_k - 1,
                          mb.d_inner + 2 * mb.n_groups * mb.d_state), dtype)}
    if blk.kind == "mlstm":
        ml = blk.mlstm
        return {"h": ((batch, ml.n_heads, ml.d_qk, ml.d_v + 1), F32)}
    if blk.kind == "slstm":
        return {k: ((batch, cfg.d_model), F32) for k in SLSTM_STATE}
    raise ValueError(blk.kind)


def _block_cache_specs(blk: Block) -> dict:
    """The logical specs of :func:`_block_caches`' caches (see
    :func:`cache_specs`)."""
    if blk.kind == "attn":
        sp = (P("batch", "tensor", None, None)
              if blk.attn.n_kv_heads % 16 == 0
              else P("batch", None, "tensor", None))
        return {"k": sp, "v": sp}
    if blk.kind == "mla":
        return {"c": P("batch", "tensor", None),
                "kpe": P("batch", "tensor", None)}
    if blk.kind == "mamba2":
        return {"ssm": P("batch", "tensor", None, None),
                "conv": P("batch", None, "tensor")}
    if blk.kind == "mlstm":
        return {"h": P("batch", None, "tensor", None)}
    if blk.kind == "slstm":
        return {k: P("batch", "tensor") for k in SLSTM_STATE}
    raise ValueError(blk.kind)


def block_cache_layouts(blk: Block, cfg: ArchConfig, mesh, batch: int,
                        smax: int) -> dict:
    """{cache name: :class:`repro_torch.pshard.Layout`} of one block's
    caches for a global batch of ``batch`` rows and ``smax`` positions on
    ``mesh``: rows over the batch axes (degraded as
    :func:`repro_torch.pshard.batch_spec` degrades them), every other dim
    as :func:`repro_torch.pshard.resolve_spec` resolves the reference's
    spec (:func:`_block_cache_specs`)."""
    rows = pshard.batch_spec(mesh, 1, batch)[0]
    specs = _block_cache_specs(blk)
    out = {}
    for n, (shape, _) in _block_caches(blk, cfg, batch, smax, F32).items():
        rest = tuple(pshard.resolve_spec(mesh, specs[n], shape))[1:]
        out[n] = pshard.Layout(pshard.P(rows, *rest), shape, mesh)
    return out


def cache_init(cfg: ArchConfig, batch: int, smax: int, dtype=torch.bfloat16,
               device=None):
    """Zero caches for decode: ``caches[si][layer]["b{bi}"]`` (a shared
    block's too: one cache per application). ``attn``: ``{"k", "v"}``
    (batch, Hk, smax, Dh); ``mla``: ``{"c", "kpe"}`` (batch, smax, r) and
    (batch, smax, d_rope); ``mamba2``: ``{"ssm"}`` (batch, H, N, P) in f32
    and ``{"conv"}`` (batch, K−1, d_inner + 2·g·N) in ``dtype``;
    ``mlstm``: ``{"h"}`` (batch, H, d_qk, d_v + 1) in f32; ``slstm``:
    ``{"h", "c", "n", "m"}`` (batch, d) in f32."""
    dev = resolve_device(device)

    def one(blk):
        return {n: torch.zeros(shape, dtype=dt, device=dev)
                for n, (shape, dt) in _block_caches(blk, cfg, batch, smax,
                                                    dtype).items()}

    return [[{f"b{bi}": one(blk) for bi, blk in enumerate(seg.blocks)}
             for _ in range(seg.repeat)] for seg in cfg.segments]


# the caches with a sequence axis (axis −2): attention's (B, Hk, S, Dh)
# and MLA's (B, S, r), (B, S, d_rope); a recurrent state has none
_SEQ_CACHES = ({"k", "v"}, {"c", "kpe"})


def cache_specs(cfg: ArchConfig) -> list:
    """The logical specs of :func:`cache_init`'s caches, in its structure:
    the reference's ``cache_init_specs`` (``model.py:335``) without the
    stacking ``None``. An attention cache's heads shard when 16 divides
    them, else its sequence, as in the reference."""
    return [[{f"b{bi}": _block_cache_specs(blk)
              for bi, blk in enumerate(seg.blocks)}
             for _ in range(seg.repeat)] for seg in cfg.segments]


def cache_positions(caches) -> int:
    """The positions of the first attention or MLA cache of a tree of
    caches (or of their layouts; 0 where there is none)."""
    for seg in caches:
        for layer in seg:
            for c in layer.values():
                if set(c) in _SEQ_CACHES:
                    return next(iter(c.values())).shape[-2]
    return 0


def pad_caches(caches, smax: int):
    """Prefill's caches (sequence S) zero-padded to ``smax`` positions, the
    layout :func:`decode_step` continues from at ``cache_len = S``. Only
    attention and MLA caches have a sequence (axis −2); Mamba2, mLSTM and
    sLSTM states pass through as they are."""
    def pad(c):
        if set(c) not in _SEQ_CACHES:
            return c
        return {n: F.pad(t, (0, 0, 0, smax - t.shape[-2]))
                for n, t in c.items()}

    return [[{b: pad(c) for b, c in layer.items()} for layer in seg]
            for seg in caches]


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _positions(b: int, s_len: int, device):
    return torch.arange(s_len, device=device).expand(b, s_len)


def embed_tokens(params, cfg: ArchConfig, tokens, dtype):
    """The embedding rows of ``tokens`` in ``dtype``. With the vocabulary
    cut over "model" the rank looks up its rows (a token outside them
    gives zero) and the rows are summed over "model": one rank gives
    each token's row, so the sum is exact."""
    table = params["embed"]
    if table.shape[0] == cfg.vocab:
        return table[tokens.long()].to(dtype)
    sh = pshard.model_shard()
    first, n = sh.block(cfg.vocab)
    local = tokens.long() - first
    mine = (local >= 0) & (local < n)
    rows = torch.where(mine[..., None], table[torch.where(mine, local, 0)],
                       0.0)
    return pshard.leave(rows, sh, "embed").to(dtype)


def _embed_inputs(params, cfg: ArchConfig, batch: dict, dtype):
    """Frontends → (x (B,S,d), positions (B,S), label mask)."""
    if cfg.frontend == "tokens":
        tokens = batch["tokens"]
        x = embed_tokens(params, cfg, tokens, dtype)
        b, s_len = tokens.shape
        mask = torch.ones((b, s_len), dtype=torch.bool, device=x.device)
    elif cfg.frontend == "frames":
        frames = batch["frames"].to(dtype)
        x = L.dot("bsf,fd->bsd", frames, params["frame_proj"], dtype)
        b, s_len = frames.shape[:2]
        mask = torch.ones((b, s_len), dtype=torch.bool, device=x.device)
    elif cfg.frontend == "vlm":
        tokens = batch["tokens"]
        img = batch["image_embeds"].to(dtype)
        ximg = L.dot("bsf,fd->bsd", img, params["patch_proj"], dtype)
        xtok = embed_tokens(params, cfg, tokens, dtype)
        x = torch.cat([ximg, xtok], dim=1)
        b, s_len = tokens.shape[0], x.shape[1]
        mask = torch.cat([
            torch.zeros((b, img.shape[1]), dtype=torch.bool, device=x.device),
            torch.ones(tokens.shape, dtype=torch.bool, device=x.device)],
            dim=1)
    else:
        raise ValueError(cfg.frontend)
    return x, _positions(b, s_len, x.device), mask


def backbone(params, cfg: ArchConfig, x, positions, want_cache: bool = False):
    """Run the block program over a full sequence → (x, caches or None).

    Where ``cfg.remat`` (and gradients are on) each block is checkpointed:
    backward recomputes one block at a time. The reference checkpoints a
    whole layer of its segment (``jax.checkpoint`` of the scan body),
    whose XLA schedule frees as it goes; a torch checkpoint of a layer
    keeps every block of it alive during its recompute (zamba2's layer is
    six Mamba2 blocks and the shared block). The numbers are the same
    either way: each block runs once forward and once recomputed."""
    all_caches = []
    remat = cfg.remat and torch.is_grad_enabled()
    for si, seg in enumerate(cfg.segments):
        seg_caches = []
        for layer_params in params["segments"][si]:
            caches = {}
            for bi, blk in enumerate(seg.blocks):
                bp = (params["shared"] if blk.shared
                      else layer_params[f"b{bi}"])
                args = (bp, blk, cfg, x, positions, want_cache)
                if remat:
                    x, caches[f"b{bi}"] = checkpoint(_block_forward, *args,
                                                     use_reentrant=False)
                else:
                    x, caches[f"b{bi}"] = _block_forward(*args)
            seg_caches.append(caches)
        all_caches.append(seg_caches)
    x = L.rmsnorm(params["final_norm"], x)
    return x, (all_caches if want_cache else None)


def _head(params, cfg: ArchConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _vocab_split(head, cfg: ArchConfig):
    """The model shard where the head holds the rank's vocabulary
    columns, else None."""
    return None if head.shape[-1] == cfg.vocab else pshard.model_shard()


def logits_for(params, cfg: ArchConfig, x):
    """f32 logits (B, S, vocab) of x (B, S, d); with the vocabulary cut
    over "model", the rank's columns gathered over it."""
    head = _head(params, cfg).to(x.dtype)
    sh = _vocab_split(head, cfg)
    logits = L.dot("bsd,dv->bsv", x, head, F32)
    if sh is None:
        return logits
    return pshard.all_gather_dim(logits, sh, -1, "logits")


def _xent_chunk(xc, lc, mc, head):
    logits = L.dot("bsd,dv->bsv", xc, head, F32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    nll = (logz - gold) * mc
    return torch.sum(nll), torch.sum(mc)


def _xent_chunk_split(xc, lc, mc, head, sh, first: int):
    """:func:`_xent_chunk` on the rank's vocabulary columns [first, first
    + V/M): the max from a MAX over "model", the sum of exponentials and
    the gold logit (from its owner, zero elsewhere) from one SUM, in
    f32."""
    logits = L.dot("bsd,dv->bsv", xc, head, F32)
    top = pshard.model_max(torch.amax(logits, dim=-1), sh, "vocab_max")
    local = lc.long() - first
    mine = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])
    gold = torch.where(mine, gold[..., 0], 0.0)
    expsum = torch.sum(torch.exp(logits - top[..., None]), dim=-1)
    both = pshard.leave(torch.stack([expsum, gold]), sh, "vocab_sum")
    logz = top + torch.log(both[0])
    nll = (logz - both[1]) * mc
    return torch.sum(nll), torch.sum(mc)


def chunked_xent(params, cfg: ArchConfig, x, labels, mask, count=None):
    """Mean cross-entropy without materialising (B, S, vocab): chunks of
    ``loss_chunk`` positions, each reduced to (loss sum, count) in order
    and dropped, each checkpointed where ``cfg.remat``. ``count``: the
    denominator in place of the mask's own count (a data-parallel rank
    divides its sum by the whole batch's count). With the vocabulary cut
    over "model" each chunk is vocab-parallel (:func:`_xent_chunk_split`)
    inside a split region."""
    b, s_len, d = x.shape
    c = min(cfg.loss_chunk, s_len)
    nchunks = -(-s_len // c)
    pad = nchunks * c - s_len
    head = _head(params, cfg).to(x.dtype)
    sh = _vocab_split(head, cfg)
    chunk, extra = _xent_chunk, ()
    if sh is not None:
        x = pshard.enter(x, sh)
        chunk, extra = _xent_chunk_split, (sh, sh.block(cfg.vocab)[0])
    xp = F.pad(x, (0, 0, 0, pad))
    lp = F.pad(labels, (0, pad))
    mp = F.pad(mask.to(F32), (0, pad))
    remat = cfg.remat and torch.is_grad_enabled()
    loss_sum = torch.zeros((), dtype=F32, device=x.device)
    total = torch.zeros((), dtype=F32, device=x.device)
    for i in range(nchunks):
        sl = slice(i * c, (i + 1) * c)
        args = (xp[:, sl], lp[:, sl], mp[:, sl], head, *extra)
        if remat:
            ls, n = checkpoint(chunk, *args, use_reentrant=False)
        else:
            ls, n = chunk(*args)
        loss_sum = loss_sum + ls
        total = total + n
    return loss_sum / torch.clamp(total if count is None else count, min=1.0)


def label_count(batch: dict) -> torch.Tensor:
    """The positions :func:`forward_loss` averages over (labels ≥ 0; the
    VLM frontend's image positions carry none), as an f32 scalar."""
    return torch.sum(batch["labels"] >= 0).to(F32)


def forward_loss(params, cfg: ArchConfig, batch: dict,
                 compute_dtype=torch.bfloat16, count=None):
    """Training forward → scalar mean cross-entropy (over ``count``
    positions when given: :func:`chunked_xent`)."""
    x, positions, mask = _embed_inputs(params, cfg, batch, compute_dtype)
    x, _ = backbone(params, cfg, x, positions)
    labels = batch["labels"]
    if cfg.frontend == "vlm":   # image positions carry no labels
        pad = torch.zeros((labels.shape[0], cfg.n_img_tokens),
                          dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    mask = mask & (labels >= 0)
    return chunked_xent(params, cfg, x, torch.clamp(labels, min=0), mask,
                        count)


def prefill(params, cfg: ArchConfig, batch: dict,
            compute_dtype=torch.bfloat16):
    """Prefill forward → (last-token logits (B, 1, V), caches)."""
    x, positions, _ = _embed_inputs(params, cfg, batch, compute_dtype)
    x, caches = backbone(params, cfg, x, positions, want_cache=True)
    return logits_for(params, cfg, x[:, -1:]), caches


def decode_step(params, cfg: ArchConfig, token, caches, cache_len,
                compute_dtype=torch.bfloat16, smax: int | None = None):
    """One decode step. token: (B, 1) ints; caches as from
    :func:`cache_init` (attention caches written in place; on a model
    axis, each in the layout :func:`layers.attn_cache_cut` gives for
    ``smax``, the whole caches' positions: by default the given caches'
    own). Returns (logits (B,1,V), caches)."""
    if smax is None:
        smax = cache_positions(caches)
    x = embed_tokens(params, cfg, token, compute_dtype)
    new_caches = []
    for si, seg in enumerate(cfg.segments):
        seg_new = []
        for layer_params, layer_cache in zip(params["segments"][si],
                                             caches[si]):
            nc = {}
            for bi, blk in enumerate(seg.blocks):
                bp = (params["shared"] if blk.shared
                      else layer_params[f"b{bi}"])
                x, nc[f"b{bi}"] = _block_decode(
                    bp, blk, cfg, x, layer_cache[f"b{bi}"], cache_len, smax)
            seg_new.append(nc)
        new_caches.append(seg_new)
    x = L.rmsnorm(params["final_norm"], x)
    return logits_for(params, cfg, x), new_caches
