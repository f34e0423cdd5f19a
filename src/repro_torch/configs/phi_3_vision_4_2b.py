"""phi-3-vision-4.2b — VLM: phi3-mini backbone + CLIP frontend stub
[hf:microsoft/Phi-3-vision-128k-instruct].

Backbone only (assignment): 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064, SwiGLU. The CLIP vision tower is a STUB — input_specs()
provides precomputed patch embeddings (B, 256, 1024) projected into the
backbone; image positions are label-masked in the loss.
"""
from .common import dense_lm


def config():
    return dense_lm(
        "phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
        n_heads=32, n_kv_heads=32, d_head=96, d_ff=8192, vocab=32064,
        ffn_kind="swiglu", frontend="vlm", n_img_tokens=256, d_patch=1024,
    )


def tiny_config():
    return dense_lm(
        "phi-3-vision-4.2b-tiny", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_head=16, d_ff=128, vocab=256,
        ffn_kind="swiglu", frontend="vlm", n_img_tokens=8, d_patch=32,
    )
