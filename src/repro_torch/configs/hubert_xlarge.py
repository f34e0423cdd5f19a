"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447].

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (masked-unit prediction
targets). Bidirectional attention, GELU FFN. The wav2vec2-style conv
feature extractor is a STUB — input_specs() provides precomputed frame
embeddings (B, S, 512). Encoder-only ⇒ no decode shapes (DESIGN §5);
positional information via rope (conv-rel-pos simplification noted).
Untied head (inputs are frames, not tokens).
"""
from .common import dense_lm


def config():
    return dense_lm(
        "hubert-xlarge", family="audio", n_layers=48, d_model=1280,
        n_heads=16, n_kv_heads=16, d_head=80, d_ff=5120, vocab=504,
        ffn_kind="gelu", causal=False, encoder_only=True, frontend="frames",
        tie_embeddings=False,
    )


def tiny_config():
    return dense_lm(
        "hubert-xlarge-tiny", family="audio", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_head=16, d_ff=128, vocab=32,
        ffn_kind="gelu", causal=False, encoder_only=True, frontend="frames",
        tie_embeddings=False,
    )
