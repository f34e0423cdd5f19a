"""Shared builders for the architecture configs.

Every assigned architecture file exposes ``config()`` (exact published dims)
and ``tiny_config()`` (same family/topology, reduced dims — used by the CPU
smoke tests; the full configs are only ever lowered abstractly by the
dry-run). Both go through the same builder, so the smoke test exercises the
identical code path as the production config.
"""

from __future__ import annotations

from ..models.layers import AttnSpec, FfnSpec, MoeSpec
from ..models.mla import MlaSpec
from ..models.model import ArchConfig, Block, Segment
from ..models.ssm import Mamba2Spec, MlstmSpec, SlstmSpec


def dense_lm(
    name: str,
    *,
    family: str = "dense",
    n_layers: int,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    d_head: int,
    d_ff: int,
    vocab: int,
    ffn_kind: str = "swiglu",
    qkv_bias: bool = False,
    qk_norm: bool = False,
    rope_theta: float = 10000.0,
    causal: bool = True,
    encoder_only: bool = False,
    frontend: str = "tokens",
    tie_embeddings: bool = True,
    **arch_kw,
) -> ArchConfig:
    attn = AttnSpec(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
                    d_head=d_head, causal=causal, qkv_bias=qkv_bias,
                    qk_norm=qk_norm, rope_theta=rope_theta)
    ffn = FfnSpec(d_model=d_model, d_ff=d_ff, kind=ffn_kind)
    blk = Block(kind="attn", attn=attn, ffn=ffn)
    return ArchConfig(
        name=name, family=family, vocab=vocab, d_model=d_model,
        segments=(Segment(n_layers, (blk,)),),
        encoder_only=encoder_only, frontend=frontend,
        tie_embeddings=tie_embeddings, **arch_kw,
    )


def local_global_lm(
    name: str,
    *,
    n_layers: int,
    local_per_global: int,
    window: int,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    d_head: int,
    d_ff: int,
    vocab: int,
    ffn_kind: str = "geglu",
    qk_norm: bool = True,
    local_theta: float = 10000.0,
    global_theta: float = 1000000.0,
    **arch_kw,
) -> ArchConfig:
    """Gemma3-style L:1 local:global stacking, expressed as super-blocks so
    the scan carries no per-layer conditionals."""
    def attn(window_, theta):
        return AttnSpec(d_model=d_model, n_heads=n_heads,
                        n_kv_heads=n_kv_heads, d_head=d_head, causal=True,
                        window=window_, qk_norm=qk_norm, rope_theta=theta)

    ffn = FfnSpec(d_model=d_model, d_ff=d_ff, kind=ffn_kind)
    loc = Block(kind="attn", attn=attn(window, local_theta), ffn=ffn)
    glb = Block(kind="attn", attn=attn(None, global_theta), ffn=ffn)
    period = local_per_global + 1
    n_super = n_layers // period
    rest = n_layers - n_super * period
    segments = [Segment(n_super, (loc,) * local_per_global + (glb,))]
    if rest:
        segments.append(Segment(1, (loc,) * rest))
    return ArchConfig(name=name, family="dense", vocab=vocab, d_model=d_model,
                      segments=tuple(segments), sub_quadratic=True, **arch_kw)


def moe_lm(
    name: str,
    *,
    n_layers: int,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    d_head: int,
    d_expert: int,
    n_routed: int,
    n_shared: int,
    top_k: int,
    vocab: int,
    n_dense_layers: int = 0,
    d_ff_dense: int = 0,
    use_mla: bool = False,
    mla: MlaSpec | None = None,
    rope_theta: float = 10000.0,
    **arch_kw,
) -> ArchConfig:
    if use_mla:
        mixer = dict(kind="mla", mla=mla)
    else:
        mixer = dict(kind="attn", attn=AttnSpec(
            d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
            d_head=d_head, causal=True, rope_theta=rope_theta))
    moe = MoeSpec(d_model=d_model, d_expert=d_expert, n_routed=n_routed,
                  n_shared=n_shared, top_k=top_k)
    moe_blk = Block(**mixer, moe=moe)
    segments = []
    if n_dense_layers:
        dense_blk = Block(**mixer, ffn=FfnSpec(d_model=d_model,
                                               d_ff=d_ff_dense))
        segments.append(Segment(n_dense_layers, (dense_blk,)))
    segments.append(Segment(n_layers - n_dense_layers, (moe_blk,)))
    return ArchConfig(name=name, family="moe", vocab=vocab, d_model=d_model,
                      segments=tuple(segments), **arch_kw)
