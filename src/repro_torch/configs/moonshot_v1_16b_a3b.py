"""moonshot-v1-16b-a3b — MoE (kimi/moonlight) [hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (GQA kv=16) MoE: 64 routed experts (d_ff=1408) top-6
+ 2 shared. vocab=163840. Per the assignment's primary spec we use standard
GQA attention (kv=16), not MLA.
"""
from .common import moe_lm


def config():
    return moe_lm(
        "moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
        n_kv_heads=16, d_head=128, d_expert=1408, n_routed=64, n_shared=2,
        top_k=6, vocab=163840,
    )


def tiny_config():
    return moe_lm(
        "moonshot-v1-16b-a3b-tiny", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_expert=32, n_routed=8, n_shared=1,
        top_k=2, vocab=256,
    )
