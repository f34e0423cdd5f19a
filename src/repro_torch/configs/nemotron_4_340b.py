"""nemotron-4-340b — dense GQA, squared-ReLU FFN [arXiv:2402.16819].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000. Untied LM head
(Nemotron reports separate output embeddings). head_dim = 18432/96 = 192.
"""
from .common import dense_lm


def config():
    return dense_lm(
        "nemotron-4-340b", n_layers=96, d_model=18432, n_heads=96,
        n_kv_heads=8, d_head=192, d_ff=73728, vocab=256000,
        ffn_kind="relu2", tie_embeddings=False,
    )


def tiny_config():
    return dense_lm(
        "nemotron-4-340b-tiny", n_layers=2, d_model=96, n_heads=8,
        n_kv_heads=2, d_head=12, d_ff=384, vocab=256, ffn_kind="relu2",
        tie_embeddings=False,
    )
