"""Architecture registry: the 10 assigned archs + input-shape catalogue, a
copy of the reference's ``src/repro/configs`` (pure data: the same fields
and defaults, built from the port's spec classes).

Shape semantics (assignment):
  train_4k     seq 4096,  global_batch 256 — lowers train_step
  prefill_32k  seq 32768, global_batch 32  — lowers prefill (forward+cache)
  decode_32k   seq 32768, global_batch 128 — lowers serve_step (1 new token,
                                             KV cache of seq_len)
  long_500k    seq 524288, global_batch 1  — serve_step; sub-quadratic archs
                                             only (see skip table / DESIGN §5)
"""

from __future__ import annotations

import dataclasses

from . import (
    codeqwen1_5_7b,
    deepseek_v2_lite_16b,
    gemma3_4b,
    hubert_xlarge,
    moonshot_v1_16b_a3b,
    nemotron_4_340b,
    phi_3_vision_4_2b,
    xlstm_350m,
    yi_9b,
    zamba2_1_2b,
)

ARCHS = {
    "codeqwen1.5-7b": codeqwen1_5_7b,
    "yi-9b": yi_9b,
    "gemma3-4b": gemma3_4b,
    "nemotron-4-340b": nemotron_4_340b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "phi-3-vision-4.2b": phi_3_vision_4_2b,
    "zamba2-1.2b": zamba2_1_2b,
    "hubert-xlarge": hubert_xlarge,
    "xlstm-350m": xlstm_350m,
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def get_config(name: str):
    return ARCHS[name].config()


def get_tiny(name: str):
    return ARCHS[name].tiny_config()


def cell_skip_reason(arch: str, shape: str) -> str | None:
    """None = runnable cell; otherwise the documented skip (DESIGN §5)."""
    cfg = get_config(arch)
    if cfg.encoder_only and shape in ("decode_32k", "long_500k"):
        return "encoder-only: no decode step"
    if shape == "long_500k" and not cfg.sub_quadratic:
        return "pure full-attention arch: long_500k skipped per assignment"
    return None


def cells():
    """All 40 nominal (arch × shape) cells with skip annotations."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES:
            out.append((arch, shape, cell_skip_reason(arch, shape)))
    return out
