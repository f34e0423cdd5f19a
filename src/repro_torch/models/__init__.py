"""The LM stack's models (attention or MLA blocks with dense or MoE
FFNs, Mamba2, mLSTM and sLSTM blocks, a shared block); see
:class:`model.ArchConfig` and :class:`model.LM`."""
from .model import (  # noqa: F401
    LM,
    ArchConfig,
    Block,
    Segment,
    backbone,
    cache_init,
    chunked_xent,
    decode_step,
    forward_loss,
    logits_for,
    pad_caches,
    prefill,
)
