"""deepseek-v2-lite-16b — MoE with MLA [arXiv:2405.04434; hf].

27L d_model=2048 16H, MLA kv_lora=512 (d_nope=128, d_rope=64, d_v=128),
layer 0 dense (d_ff=10944), layers 1-26 MoE: 64 routed experts (d_ff=1408)
top-6 + 2 shared experts. vocab=102400.

NOTE (DESIGN §5): the assignment bracket says "2 shared+160 routed" which is
the *full* V2 config; the primary spec line and the HF Lite config say 64
routed — we follow the primary spec.
"""
from ..models.mla import MlaSpec

from .common import moe_lm


def config():
    return moe_lm(
        "deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16,
        n_kv_heads=16, d_head=128, d_expert=1408, n_routed=64, n_shared=2,
        top_k=6, vocab=102400, n_dense_layers=1, d_ff_dense=10944,
        use_mla=True,
        mla=MlaSpec(d_model=2048, n_heads=16, kv_lora_rank=512, d_nope=128,
                    d_rope=64, d_v=128),
    )


def tiny_config():
    return moe_lm(
        "deepseek-v2-lite-16b-tiny", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_expert=32, n_routed=8, n_shared=1,
        top_k=2, vocab=256, n_dense_layers=1, d_ff_dense=128, use_mla=True,
        mla=MlaSpec(d_model=64, n_heads=4, kv_lora_rank=32, d_nope=16,
                    d_rope=8, d_v=16),
    )
