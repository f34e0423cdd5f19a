"""gemma3-4b — dense, 5:1 local:global attention, 128k ctx
[hf:google/gemma-3-*-pt; unverified tier].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144. head_dim=256
(independent of d_model, gemma signature), GeGLU, qk-norm, sliding window
1024 on local layers (theta 10k) / full attention on every 6th (theta 1M).
Sub-quadratic (long_500k eligible): decode touches only the 1024-token window
on 29/34 layers.
"""
from .common import local_global_lm


def config():
    return local_global_lm(
        "gemma3-4b", n_layers=34, local_per_global=5, window=1024,
        d_model=2560, n_heads=8, n_kv_heads=4, d_head=256, d_ff=10240,
        vocab=262144,
    )


def tiny_config():
    return local_global_lm(
        "gemma3-4b-tiny", n_layers=6, local_per_global=2, window=16,
        d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
    )
