"""zamba2-1.2b — hybrid Mamba2 backbone + shared attention block
[arXiv:2411.15242].

38 Mamba2 blocks (d_model=2048, d_inner=4096, 64 heads × head_dim 64,
ssm_state=64) with a single *weight-shared* (attention 32H + MLP d_ff=8192)
block applied every 6 Mamba blocks (6 applications). The real Zamba2 adds
per-application LoRA deltas to the shared block — we share it exactly and
note the simplification (DESIGN §5). Sub-quadratic: eligible for long_500k
(SSM state is O(1); the shared-attn KV grows with S but is 6 applications,
window-free — dominated by the Mamba backbone).
"""
from ..models.layers import AttnSpec, FfnSpec
from ..models.model import ArchConfig, Block, Segment
from ..models.ssm import Mamba2Spec


def _build(name, d_model, n_mamba, period, n_heads, n_kv, d_head, d_ff,
           d_state, vocab, head_dim):
    mamba = Block(kind="mamba2", mamba=Mamba2Spec(
        d_model=d_model, d_state=d_state, expand=2, head_dim=head_dim))
    shared = Block(
        kind="attn",
        attn=AttnSpec(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
                      d_head=d_head, causal=True),
        ffn=FfnSpec(d_model=d_model, d_ff=d_ff), shared=True)
    n_super = n_mamba // period
    rest = n_mamba - n_super * period
    segments = [Segment(n_super, (mamba,) * period + (shared,))]
    if rest:
        segments.append(Segment(1, (mamba,) * rest))
    # the shared block's params live once, at the config level
    shared_params_blk = Block(
        kind="attn",
        attn=shared.attn, ffn=shared.ffn, shared=False)
    return ArchConfig(name=name, family="hybrid", vocab=vocab,
                      d_model=d_model, segments=tuple(segments),
                      shared_block=shared_params_blk, sub_quadratic=True)


def config():
    return _build("zamba2-1.2b", d_model=2048, n_mamba=38, period=6,
                  n_heads=32, n_kv=32, d_head=64, d_ff=8192, d_state=64,
                  vocab=32000, head_dim=64)


def tiny_config():
    return _build("zamba2-1.2b-tiny", d_model=64, n_mamba=5, period=2,
                  n_heads=4, n_kv=4, d_head=16, d_ff=128, d_state=16,
                  vocab=256, head_dim=16)
