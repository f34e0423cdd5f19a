"""AdamW (``repro_torch.optim.adamw``) against the reference's
``repro.optim.adamw`` on the CPU: several steps on the same parameters
and gradients with f32 and bf16 moments, top-k error feedback, the
schedule and the global-norm clip. f32 to rtol 1e-6 (the same f32
arithmetic in the same order: the two differ by a last-bit pow, sqrt or
cos); bf16 moments and the bf16 error buffer to one bf16 rounding."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.optim import adamw as JA
from repro_torch.optim import adamw as TA

SHAPES = {"a": (6, 5), "b": (7,), "c": (3, 4, 2)}


def _trees(seed):
    rng = np.random.default_rng(seed)
    arrs = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v.copy()) for k, v in arrs.items()})


def _close(t, j, rtol):
    j = np.asarray(jnp.asarray(j, jnp.float32))
    t = t.float().numpy()
    np.testing.assert_allclose(t, j, rtol=rtol,
                               atol=rtol * max(np.abs(j).max(), 1e-30))


CASES = {
    "f32": dict(),
    "bf16_moments": dict(moment_dtype="bfloat16"),
    "topk": dict(topk_compress=0.3),
    "clipped": dict(grad_clip=0.05, weight_decay=0.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_update_matches_reference(case):
    kw = CASES[case]
    cfg_j = JA.OptConfig(lr=1e-2, warmup_steps=2, total_steps=8, **kw)
    cfg_t = TA.OptConfig(lr=1e-2, warmup_steps=2, total_steps=8, **kw)
    jp, tp = _trees(0)
    js, ts = JA.init(cfg_j, jp), TA.init(cfg_t, tp)
    lo = case != "f32" and case != "clipped"
    rtol = 1e-2 if lo else 1e-6
    for step in range(5):
        jg, tg = _trees(10 + step)
        jp, js, jm = JA.update(cfg_j, js, jp, jg)
        tp, ts, tm = TA.update(cfg_t, ts, tp, tg)
        for k in SHAPES:
            _close(tp[k], jp[k], rtol)
            _close(ts.m[k], js.m[k], rtol)
            _close(ts.v[k], js.v[k], rtol)
            assert ts.m[k].dtype == (torch.bfloat16 if "bf16" in case
                                     else torch.float32)
            if cfg_t.topk_compress:
                _close(ts.err[k], js.err[k], 1e-2)
        assert int(ts.step) == int(js.step) == step + 1
        _close(tm["lr"], jm["lr"], 1e-6)
        _close(tm["grad_norm"], jm["grad_norm"], 1e-6)


def test_inplace_update_equals_functional():
    cfg = TA.OptConfig(lr=1e-2, warmup_steps=2, moment_dtype="bfloat16")
    _, p1 = _trees(0)
    _, p2 = _trees(0)
    s1, s2 = TA.init(cfg, p1), TA.init(cfg, p2)
    for step in range(3):
        _, g = _trees(20 + step)
        p1, s1, _ = TA.update(cfg, s1, p1, dict(g))
        out, s2, _ = TA.update(cfg, s2, p2, dict(g), inplace=True)
        assert all(out[k] is p2[k] for k in p2)
    for k in SHAPES:
        assert torch.equal(p1[k], p2[k])
        assert torch.equal(s1.m[k], s2.m[k]) and torch.equal(s1.v[k], s2.v[k])


def test_schedule_matches_reference():
    cfg_j = JA.OptConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    cfg_t = TA.OptConfig(**dataclasses.asdict(cfg_j))
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        _close(TA.schedule(cfg_t, torch.tensor(s, dtype=torch.int32)),
               JA.schedule(cfg_j, jnp.asarray(s, jnp.int32)), 1e-6)


def test_clip_and_norm_match_reference():
    jg, tg = _trees(3)
    _close(TA.global_norm(tg), JA.global_norm(jg), 1e-6)
    for max_norm in (0.1, 1e3):
        jc, jn = JA.clip_by_global_norm(jg, max_norm)
        tc, tn = TA.clip_by_global_norm(tg, max_norm)
        _close(tn, jn, 1e-6)
        for k in SHAPES:
            _close(tc[k], jc[k], 1e-6)


def test_topk_compress_matches_reference():
    cfg = TA.OptConfig(topk_compress=0.25)
    jg, tg = _trees(4)
    je, te = _trees(5)
    je = {k: v.astype(jnp.bfloat16) for k, v in je.items()}
    te = {k: v.to(torch.bfloat16) for k, v in te.items()}
    jgs, jes = JA.topk_compress(JA.OptConfig(topk_compress=0.25), jg, je)
    tgs, tes = TA.topk_compress(cfg, tg, te)
    for k in SHAPES:
        np.testing.assert_array_equal(tgs[k].numpy(), np.asarray(jgs[k]))
        _close(tes[k], jes[k], 1e-2)
        kept = int((tgs[k] != 0).sum())
        assert kept == max(1, int(tgs[k].numel() * 0.25))
