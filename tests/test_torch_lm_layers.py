"""The LM stack's layers (``repro_torch.models.layers``) against the
reference's (``repro.models.layers``) on the same numpy-seeded inputs, on
the CPU: RMSNorm, RoPE, chunked attention (causal, sliding window, GQA,
q_offset, a value dim other than q/k's, ragged chunks), the attention
layer (qkv bias, qk-norm; forward and decode) and the four FFN kinds.

Tolerances: f32 compute to rtol 1e-5 (atol 1e-5 of the output's scale);
bf16 compute to 2e-2 of the output's scale (bf16 keeps 8 bits: 3.9e-3
relative per rounding, and a layer rounds several times).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _close(got, want, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _pair(a, dtype):
    """The same numpy array as a jax and a torch array of ``dtype``."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def _tree(jparams):
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in jparams.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 24)) * 3
    scale = rng.uniform(0.5, 1.5, 24)
    jx, tx = _pair(x, dtype)
    want = JL.rmsnorm({"scale": jnp.asarray(scale, jnp.float32)}, jx,
                      offset=0.5)
    got = TL.rmsnorm({"scale": torch.tensor(scale, dtype=torch.float32)}, tx,
                     offset=0.5)
    assert got.dtype == tx.dtype
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("theta", [1e4, 5e6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(theta, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 70, 3, 16))
    pos = np.broadcast_to(np.arange(70) + 5, (2, 70))
    jx, tx = _pair(x, dtype)
    want = JL.rope(jx, jnp.asarray(pos), theta)
    got = TL.rope(tx, torch.from_numpy(pos.copy()), theta)
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


ATTN_CASES = [
    # (hq, hkv, sq, sk, d, dv, causal, window, q_offset, q_chunk, k_chunk)
    (4, 4, 40, 40, 8, 8, True, None, 0, 16, 16),       # causal, ragged chunks
    (8, 2, 33, 33, 8, 8, True, None, 0, 8, 16),        # GQA
    (4, 2, 50, 50, 8, 8, True, 12, 0, 8, 8),           # sliding window
    (4, 4, 24, 24, 8, 8, False, None, 0, 16, 8),       # bidirectional
    (4, 2, 6, 30, 8, 12, True, None, 24, 4, 8),        # q_offset, dv != d
    (4, 4, 10, 10, 8, 8, True, 4, 0, 1024, 1024),      # one chunk each
]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention(case, dtype):
    hq, hkv, sq, sk, d, dv, causal, window, off, qc, kc = case
    rng = np.random.default_rng(hq * 100 + sq)
    q, k, v = (rng.standard_normal((2, h, s, e))
               for h, s, e in ((hq, sq, d), (hkv, sk, d), (hkv, sk, dv)))
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(k, dtype)
    jv, tv = _pair(v, dtype)
    kw = dict(causal=causal, window=window, q_offset=off, q_chunk=qc,
              k_chunk=kc)
    want = JL.chunked_attention(jq, jk, jv, **kw)
    got = TL.chunked_attention(tq, tk, tv, **kw)
    assert got.shape == want.shape and got.dtype == tq.dtype
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


def test_chunked_attention_gradients_match_reference():
    """The checkpointed kv steps (and the skipped masked tiles) give the
    reference's gradients."""
    rng = np.random.default_rng(3)
    q, k = rng.standard_normal((2, 2, 4, 20, 8))
    v = rng.standard_normal((2, 4, 20, 8))
    w = rng.standard_normal((2, 4, 20, 8))
    kw = dict(causal=True, window=6, q_offset=0, q_chunk=8, k_chunk=4)

    def jloss(q, k, v):
        return jnp.sum(JL.chunked_attention(q, k, v, **kw) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a, jnp.float32)
                                             for a in (q, k, v)))
    ts = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
          for a in (q, k, v)]
    torch.sum(TL.chunked_attention(*ts, **kw)
              * torch.from_numpy(w).float()).backward()
    for t, j in zip(ts, jg):
        _close(t.grad, j, F32_TOL)


def _attn_spec(**kw):
    base = dict(d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
                rope_theta=1e6)
    base.update(kw)
    return base


SPECS = [dict(), dict(qkv_bias=True), dict(qk_norm=True, window=5),
         dict(causal=False, n_kv_heads=4)]


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_layer(kw, dtype):
    js = JL.AttnSpec(**_attn_spec(**kw))
    ts = TL.AttnSpec(**_attn_spec(**kw))
    jp, _ = JL.attn_init(jax.random.PRNGKey(0), js)
    if js.qkv_bias:   # non-zero biases, so the test sees them
        r = np.random.default_rng(9)
        jp = dict(jp, **{b: jnp.asarray(r.standard_normal(jp[b].shape) * 0.1,
                                        jnp.float32)
                         for b in ("bq", "bk", "bv")})
    tp = _tree(jp)
    if dtype == "bfloat16":   # the train step's cast of every ndim > 1 leaf
        jp = {k: v.astype(jnp.bfloat16) if v.ndim > 1 else v
              for k, v in jp.items()}
        tp = {k: v.to(torch.bfloat16) if v.dim() > 1 else v
              for k, v in tp.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 19, 32))
    pos = np.broadcast_to(np.arange(19), (2, 19))
    jx, tx = _pair(x, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    want = JL.attn_forward(jp, js, jx, jnp.asarray(pos), q_chunk=8, k_chunk=4)
    got = TL.attn_forward(tp, ts, tx, torch.from_numpy(pos.copy()),
                          q_chunk=8, k_chunk=4)
    _close(got, want, tol)
    # decode one token at position 7 against a cache of 12
    ck = rng.standard_normal((2, js.n_kv_heads, 12, 8))
    cv = rng.standard_normal((2, js.n_kv_heads, 12, 8))
    jo, jck, jcv = JL.attn_decode(jp, js, jx[:, :1], *(_pair(c, dtype)[0]
                                                      for c in (ck, cv)), 7)
    to, tck, tcv = TL.attn_decode(tp, ts, tx[:, :1], *(_pair(c, dtype)[1]
                                                      for c in (ck, cv)), 7)
    for g, w in ((to, jo), (tck, jck), (tcv, jcv)):
        _close(g, w, tol)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn(kind, dtype):
    jspec = JL.FfnSpec(d_model=24, d_ff=40, kind=kind)
    tspec = TL.FfnSpec(d_model=24, d_ff=40, kind=kind)
    jp, _ = JL.ffn_init(jax.random.PRNGKey(1), jspec)
    tp = _tree(jp)
    if dtype == "bfloat16":
        jp = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
        tp = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    x = np.random.default_rng(5).standard_normal((2, 7, 24))
    jx, tx = _pair(x, dtype)
    want = JL.ffn_forward(jp, jspec, jx)
    got = TL.ffn_forward(tp, tspec, tx)
    assert got.dtype == tx.dtype
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


def test_modules_hold_the_reference_shapes():
    """``Attention``/``Ffn`` own the parameters ``attn_init``/``ffn_init``
    make, under the same names and shapes."""
    gen = torch.Generator().manual_seed(0)
    for kw in SPECS:
        jp, _ = JL.attn_init(jax.random.PRNGKey(0),
                             JL.AttnSpec(**_attn_spec(**kw)))
        tp = TL.param_tree(TL.Attention(TL.AttnSpec(**_attn_spec(**kw)),
                                        gen))
        assert {k: v.shape for k, v in jp.items()} == \
            {k: tuple(v.shape) for k, v in tp.items()}
    for kind in ("swiglu", "geglu", "relu2", "gelu"):
        jp, _ = JL.ffn_init(jax.random.PRNGKey(0), JL.FfnSpec(8, 16, kind))
        tp = TL.param_tree(TL.Ffn(TL.FfnSpec(8, 16, kind), gen))
        assert {k: v.shape for k, v in jp.items()} == \
            {k: tuple(v.shape) for k, v in tp.items()}
