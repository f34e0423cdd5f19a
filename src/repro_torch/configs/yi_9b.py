"""yi-9b — dense llama-arch GQA [arXiv:2403.04652].

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000, SwiGLU, theta 5e6.
"""
from .common import dense_lm


def config():
    return dense_lm(
        "yi-9b", n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
        d_head=128, d_ff=11008, vocab=64000, ffn_kind="swiglu",
        rope_theta=5e6,
    )


def tiny_config():
    return dense_lm(
        "yi-9b-tiny", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_head=8, d_ff=128, vocab=256, ffn_kind="swiglu", rope_theta=5e6,
    )
