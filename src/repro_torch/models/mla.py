"""Multi-head Latent Attention (DeepSeek-V2): the spec only.

``MlaSpec`` is the reference's dataclass (``src/repro/models/mla.py``), so
the MLA configs construct; building an ``mla`` block raises
``NotImplementedError`` naming ROADMAP item 14b.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MlaSpec:
    d_model: int
    n_heads: int
    kv_lora_rank: int = 512
    d_nope: int = 128            # per-head non-rotary q/k dim
    d_rope: int = 64             # shared rotary dim
    d_v: int = 128               # per-head value dim
    rope_theta: float = 10000.0
