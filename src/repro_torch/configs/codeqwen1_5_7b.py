"""codeqwen1.5-7b — dense, qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B].

32L d_model=4096 32H (GQA kv=32 ≡ MHA) d_ff=13440 vocab=92416, SwiGLU,
qkv bias (qwen signature), rope theta 1e6 (64k context training).
"""
from .common import dense_lm


def config():
    return dense_lm(
        "codeqwen1.5-7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=32, d_head=128, d_ff=13440, vocab=92416,
        ffn_kind="swiglu", qkv_bias=True, rope_theta=1e6,
    )


def tiny_config():
    return dense_lm(
        "codeqwen1.5-7b-tiny", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab=256,
        ffn_kind="swiglu", qkv_bias=True, rope_theta=1e6,
    )
