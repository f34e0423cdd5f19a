"""Multi-head Latent Attention (``repro_torch.models.mla``) and the serving
paths of the MoE architectures (prefill, decode, MLA caches) against the
reference on the CPU, on the same numpy-seeded inputs:

* ``mla_forward`` (the expanded form, its latent cache too) and
  ``mla_decode`` (the absorbed form, writing the cache at ``cache_len``)
  at deepseek-v2-lite's tiny widths (4 heads, r 32, d_nope 16, d_rope 8,
  d_v 16) in f32 (rtol 1e-5 of the output's scale) and bf16 (2e-2);
* ``cache_init`` of both MoE architectures against the reference's
  shapes; ``prefill`` (last logits, every cache) and one ``decode_step``
  against the reference's (1e-4);
* a decode that continues from a prefill's caches padded by
  ``pad_caches`` (an MLA cache is (B, S, r): its sequence is axis 1)
  against the reference's decode from its own padded caches, and
  token-by-token decode against the full forward (the reference's
  ``test_decode_matches_forward`` contract, rtol 2e-2 and atol 2e-2, and
  1e-4 of the logits' scale), at the dropless capacity factor 16.0: a
  group of 12 tokens and a group of one route alike only when nothing
  drops.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as JC
from repro.models import mla as JMLA
from repro.models import model as JM
from repro_torch import configs as TC
from repro_torch.models import LM, cache_init, pad_caches
from repro_torch.models import mla as TMLA
from repro_torch.models import model as TM
from torch_lm_util import MOE, carried, close_to, with_capacity

F32_TOL = 1e-5
BF16_TOL = 2e-2
DROPLESS = 16.0


def _specs():
    pick = lambda cfg: cfg.segments[0].blocks[0].mla
    return pick(JC.get_tiny(MOE[0])), pick(TC.get_tiny(MOE[0]))


def _params(seed: int, dtype: str):
    """The reference's MLA parameters in both packages, in ``dtype``."""
    jspec, _ = _specs()
    jp, _ = JMLA.mla_init(jax.random.PRNGKey(seed), jspec)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    if dtype == "bfloat16":
        jp = jax.tree.map(lambda v: v.astype(jnp.bfloat16), jp)
        tp = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    return jp, tp


def _pair(a, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return (jnp.asarray(a, jd),
            torch.from_numpy(np.asarray(a, np.float32)).to(td))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_forward_matches_reference(dtype):
    jspec, tspec = _specs()
    jp, tp = _params(21, dtype)
    x = np.random.default_rng(22).standard_normal((2, 40, jspec.d_model))
    jx, tx = _pair(x, dtype)
    pos = np.broadcast_to(np.arange(40), (2, 40))
    # chunks of 16 over 40 positions: ragged tiles and skipped ones
    want, (jc, jk) = JMLA.mla_forward(jp, jspec, jx, jnp.asarray(pos),
                                      q_chunk=16, k_chunk=16)
    got, (tc, tk) = TMLA.mla_forward(tp, tspec, tx,
                                     torch.from_numpy(pos.copy()),
                                     q_chunk=16, k_chunk=16)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert tc.shape == (2, 40, jspec.kv_lora_rank)
    assert tk.shape == (2, 40, jspec.d_rope)
    for g, w in ((got, want), (tc, jc), (tk, jk)):
        close_to(g, w, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_reference(dtype):
    """One absorbed decode step at position 9 of a 16-position cache that
    holds 9 earlier positions (and stale values past them, which the
    mask must hide)."""
    jspec, tspec = _specs()
    jp, tp = _params(23, dtype)
    rng = np.random.default_rng(24)
    x = rng.standard_normal((2, 1, jspec.d_model))
    c = rng.standard_normal((2, 16, jspec.kv_lora_rank))
    kpe = rng.standard_normal((2, 16, jspec.d_rope))
    jx, tx = _pair(x, dtype)
    (jcc, tcc), (jck, tck) = _pair(c, dtype), _pair(kpe, dtype)
    want, wc, wk = JMLA.mla_decode(jp, jspec, jx, jcc, jck, jnp.asarray(9))
    got, gc, gk = TMLA.mla_decode(tp, tspec, tx, tcc, tck, 9)
    assert gc is tcc and gk is tck                 # written in place
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for g, w in ((got, want), (gc, wc), (gk, wk)):
        close_to(g, w, tol)


@pytest.mark.parametrize("arch", MOE)
def test_cache_init_matches_reference(arch):
    jcaches, _ = JM.cache_init(JC.get_tiny(arch), 2, 16, dtype=jnp.float32)
    tcaches = cache_init(TC.get_tiny(arch), 2, 16, dtype=torch.float32,
                         device="cpu")
    for si, seg in enumerate(tcaches):
        for layer in seg:
            for b, c in layer.items():
                assert sorted(c) == sorted(jcaches[si][b])
                for n, t in c.items():
                    assert tuple(t.shape) == jcaches[si][b][n].shape[1:]
                    assert not t.any()


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_reference(arch):
    jc, tc, params, model = carried(arch, seed=6)
    toks = np.random.default_rng(7).integers(0, jc.vocab, (2, 20),
                                             dtype=np.int32)
    jl, jcache = JM.prefill(params, jc, {"tokens": jnp.asarray(toks)},
                            compute_dtype=jnp.float32)
    with torch.no_grad():
        tl, tcache = model.prefill({"tokens": torch.from_numpy(toks)},
                                   compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jl)).max())
    for si, seg in enumerate(tcache):
        for li, layer in enumerate(seg):
            for b, c in layer.items():
                assert sorted(c) == sorted(jcache[si][b])
                for n, t in c.items():
                    np.testing.assert_allclose(
                        t.numpy(), np.asarray(jcache[si][b][n][li]),
                        rtol=1e-5, atol=1e-5)
    # one decode step at position 9 of a 16-position cache
    tok = np.random.default_rng(8).integers(0, jc.vocab, (2, 1),
                                            dtype=np.int32)
    jdc, _ = JM.cache_init(jc, 2, 16, dtype=jnp.float32)
    jl, _ = JM.decode_step(params, jc, jnp.asarray(tok), jdc, jnp.asarray(9),
                           compute_dtype=jnp.float32)
    with torch.no_grad():
        tl, _ = model.decode_step(torch.from_numpy(tok),
                                  cache_init(tc, 2, 16, dtype=torch.float32,
                                             device="cpu"), 9,
                                  compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jl)).max())


def _full_logits(model, cfg, toks):
    with torch.no_grad():
        tree = model.tree()
        x, pos, _ = TM._embed_inputs(tree, cfg, {"tokens": toks},
                                     torch.float32)
        h, _ = TM.backbone(tree, cfg, x, pos)
        return TM.logits_for(tree, cfg, h).numpy()


@pytest.mark.parametrize("arch", MOE)
def test_decode_continues_from_padded_prefill(arch):
    """Prefill 8 tokens, pad the caches to 12 with ``pad_caches``, decode
    the last 4: the reference's logits (prefill and decode of its own,
    its stacked caches padded on their sequence axis) and the forward's."""
    jc, tc, params, model = carried(arch, seed=9)
    jc, tc = with_capacity(jc, DROPLESS), with_capacity(tc, DROPLESS)
    s, p = 12, 8
    toks = np.random.default_rng(10).integers(0, jc.vocab, (1, s),
                                              dtype=np.int32)
    tt = torch.from_numpy(toks)
    _, jcache = JM.prefill(params, jc, {"tokens": jnp.asarray(toks[:, :p])},
                           compute_dtype=jnp.float32)
    jcache = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0)] * (a.ndim - 2) + [(0, s - p), (0, 0)]),
        jcache)
    tree = model.tree()                 # run on tc, the dropless config
    with torch.no_grad():
        _, pc = TM.prefill(tree, tc, {"tokens": tt[:, :p]},
                           compute_dtype=torch.float32)
        pc = pad_caches(pc, s)
        for seg in pc:
            for layer in seg:
                for c in layer.values():
                    assert all(t.shape[-2] == s for t in c.values())
        want, got = [], []
        for t in range(p, s):
            jl, jcache = JM.decode_step(
                params, jc, jnp.asarray(toks[:, t:t + 1]), jcache,
                jnp.asarray(t), compute_dtype=jnp.float32)
            tl, pc = TM.decode_step(tree, tc, tt[:, t:t + 1], pc, t,
                                    compute_dtype=torch.float32)
            want.append(np.asarray(jl)[:, 0])
            got.append(tl[:, 0].numpy())
    want, got = np.stack(want, 1), np.stack(got, 1)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * scale
    full = _full_logits(model, tc, tt)[:, p:]
    assert np.abs(got - full).max() <= 1e-4 * np.abs(full).max()


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_forward(arch):
    """Token-by-token decode from empty caches gives the full forward's
    logits at every position."""
    tc = with_capacity(TC.get_tiny(arch), DROPLESS)
    model = LM(tc, seed=3, device="cpu")
    s = 12
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tc.vocab, (1, s), dtype=np.int32))
    full = _full_logits(model, tc, toks)
    caches = cache_init(tc, 1, s, dtype=torch.float32, device="cpu")
    outs = []
    with torch.no_grad():
        for t in range(s):
            lg, caches = model.decode_step(toks[:, t:t + 1], caches, t,
                                           compute_dtype=torch.float32)
            outs.append(lg[:, 0].numpy())
    dec = np.stack(outs, axis=1)
    np.testing.assert_allclose(dec, full, rtol=2e-2, atol=2e-2)
    assert np.abs(dec - full).max() <= 1e-4 * np.abs(full).max()
