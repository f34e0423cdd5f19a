"""State-space and recurrent mixers (Mamba2, mLSTM, sLSTM): the specs only.

The dataclasses are the reference's (``src/repro/models/ssm.py``), with
their derived properties, so the zamba2 and xlstm configs construct;
building a ``mamba2``, ``mlstm`` or ``slstm`` block raises
``NotImplementedError`` naming ROADMAP item 14c.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Mamba2Spec:
    d_model: int
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_k: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


@dataclasses.dataclass(frozen=True)
class MlstmSpec:
    d_model: int
    n_heads: int = 4
    expand: int = 2
    qk_factor: float = 0.5          # d_qk = qk_factor · d_v
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def d_v(self) -> int:
        return self.d_inner // self.n_heads

    @property
    def d_qk(self) -> int:
        return int(self.d_v * self.qk_factor)


@dataclasses.dataclass(frozen=True)
class SlstmSpec:
    d_model: int
    n_heads: int = 4
    proj_factor: float = 4.0 / 3.0

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_up(self) -> int:
        return int(self.d_model * self.proj_factor)
