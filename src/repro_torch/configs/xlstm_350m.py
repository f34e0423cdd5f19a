"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517].

24 blocks d_model=1024, xLSTM[7:1] stacking (7 mLSTM : 1 sLSTM, 3 super-
blocks). d_ff=0 per the assignment: blocks carry only their internal
up/down projections (mLSTM expand=2, qk_factor=0.5; sLSTM proj_factor=4/3).
4 heads. Fully recurrent ⇒ sub-quadratic, long_500k eligible (O(1) state).
"""
from ..models.model import ArchConfig, Block, Segment
from ..models.ssm import MlstmSpec, SlstmSpec


def _build(name, d_model, n_super, m_per_s, n_heads, vocab):
    mb = Block(kind="mlstm", mlstm=MlstmSpec(d_model=d_model,
                                             n_heads=n_heads))
    sb = Block(kind="slstm", slstm=SlstmSpec(d_model=d_model,
                                             n_heads=n_heads))
    return ArchConfig(
        name=name, family="ssm", vocab=vocab, d_model=d_model,
        segments=(Segment(n_super, (mb,) * m_per_s + (sb,)),),
        sub_quadratic=True,
    )


def config():
    return _build("xlstm-350m", d_model=1024, n_super=3, m_per_s=7,
                  n_heads=4, vocab=50304)


def tiny_config():
    return _build("xlstm-350m-tiny", d_model=64, n_super=2, m_per_s=1,
                  n_heads=2, vocab=256)
