"""The LM train step (``repro_torch.train.steps``) against the reference's
``make_train_step`` on the CPU, and the port's own loss decrease.

The reference's jitted step runs on a 1×1 mesh built with auto axis
types, ``Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data",
"model"))``: jax 0.9's ``jax.make_mesh`` makes explicit axes, on which its
``jnp.take`` raises ``ShardingTypeError`` (why the reference's own
``test_system::test_train_loop_loss_decreases`` fails). Both start from
the same parameters (``train_state_from_reference``) and take the same
batches (``SyntheticLM``).

Tolerances. f32 compute with f32 gradients: losses to rtol 1e-5; the
parameters after 3 steps within atol 1e-5 + rtol 1e-4 everywhere but at
most 0.1 % of the entries (Adam's m/√v turns a last-bit gradient
difference on a near-zero gradient into up to ±lr), none further than
2·lr. bf16 compute (one microbatch, and ``accum_steps=2``): losses to
rtol 1e-3, and the 3-step update within 0.15 relative (cosine ≥ 0.99):
the reference's own bf16 and f32 updates differ by 0.082 on this setup,
so bf16 roundings, not the step, set that scale. Each case prints its
count of entries outside the tight tolerance.

Those bf16 limits alone would pass a step that skipped the compute-dtype
cast or the gradients' bf16 rounding: XLA's bf16 arithmetic on the CPU
and torch's round at other places, so the two packages' bf16 steps lie
about as far apart as either lies from f32. The first step's gradients
tell the precision: with β₁ = 0 and no clipping AdamW's first moment is
the gradient bit for bit, and

* on one microbatch every gradient is a bf16 value (the round trip), and
  with ``accum_steps=2`` twice every gradient is (the bf16 sum);
* the port's bf16 gradient lies from the reference's f32 one within
  [0.5, 2] × the reference's own bf16-to-f32 distance (a step computed
  in f32 sits at the ~0.002 of the gradients' rounding, against 0.018);
* and no further from the reference's bf16 gradient than the
  reference's f32 gradient is (0.014 against 0.018 on this setup).
"""

import numpy as np
import jax
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as JC
from repro.data import device_batch
from repro.optim import adamw as JA
from repro.train import steps as JST
from repro_torch import configs as TC
from repro_torch.convert import (train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.data import SyntheticLM, to_device
from repro_torch.optim import adamw as TA
from repro_torch.train import steps as TST

LR = 5e-3
CASES = {
    "f32_fp32_grads": dict(compute_dtype="float32", fp32_grads=True),
    "bf16": dict(),
    "bf16_accum2": dict(accum_steps=2),
}


def _auto_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference(case):
    kw = CASES[case]
    mesh = _auto_mesh()
    jc, tcfg = JC.get_tiny("yi-9b"), TC.get_tiny("yi-9b")
    jt = JST.TrainConfig(opt=JA.OptConfig(lr=LR, warmup_steps=2,
                                          total_steps=60), **kw)
    tt = TST.TrainConfig(opt=TA.OptConfig(lr=LR, warmup_steps=2,
                                          total_steps=60), **kw)
    js, jsh = JST.init_state(jax.random.PRNGKey(0), jc, jt, mesh)
    p0 = [np.asarray(x) for x in jax.tree.leaves(js.params)]
    ts = train_state_from_reference(jax.tree.map(np.asarray, js), tcfg,
                                    device="cpu")
    src = SyntheticLM(vocab=jc.vocab, seq=32, global_batch=4)
    b0 = device_batch(mesh, src.host_batch(0))
    jstep = JST.make_train_step(jc, jt, mesh, jsh,
                                {k: v.sharding for k, v in b0.items()})
    tstep = TST.make_train_step(tcfg, tt)
    jl, tl = [], []
    for i in range(3):
        hb = src.host_batch(i)
        js, jm = jstep(js, device_batch(mesh, hb))
        ts, tm = tstep(ts, to_device(hb, "cpu"))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    assert int(ts.step) == int(js.step) == 3
    assert int(ts.opt.step) == int(js.opt.step) == 3
    want = [np.asarray(x) for x in jax.tree.leaves(js.params)]
    got = jax.tree.leaves(train_state_to_reference(ts).params)
    err = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    lim = np.concatenate([(1e-5 + 1e-4 * np.abs(w)).ravel() for w in want])
    outside = int((err > lim).sum())
    dw = np.concatenate([(w - z).ravel() for w, z in zip(want, p0)])
    dg = np.concatenate([(g - z).ravel() for g, z in zip(got, p0)])
    rel = np.linalg.norm(dg - dw) / np.linalg.norm(dw)
    cos = dg @ dw / np.linalg.norm(dg) / np.linalg.norm(dw)
    print(f"{case}: losses {tl} vs {jl}; {outside} of {err.size} entries "
          f"outside atol 1e-5 + rtol 1e-4 (max {err.max():.3g}); update "
          f"relative error {rel:.3g}, cosine {cos:.6f}")
    if case == "f32_fp32_grads":
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert outside <= 1e-3 * err.size and err.max() <= 2 * LR
        assert rel <= 1e-3
    else:
        np.testing.assert_allclose(tl, jl, rtol=1e-3)
        assert rel <= 0.15 and cos >= 0.99


def _first_gradients(pkg, compute_dtype, kw):
    """The gradients the first step hands AdamW: its first moment after
    one step with β₁ = 0 and clipping off, flat, in the reference's leaf
    order."""
    mesh = _auto_mesh()
    opt = dict(lr=LR, warmup_steps=2, total_steps=60, betas=(0.0, 0.95),
               grad_clip=1e9)
    jc = JC.get_tiny("yi-9b")
    jt = JST.TrainConfig(opt=JA.OptConfig(**opt),
                         compute_dtype=compute_dtype, **kw)
    js, jsh = JST.init_state(jax.random.PRNGKey(0), jc, jt, mesh)
    hb = SyntheticLM(vocab=jc.vocab, seq=32, global_batch=4).host_batch(0)
    if pkg == "reference":
        b0 = device_batch(mesh, hb)
        step = JST.make_train_step(jc, jt, mesh, jsh,
                                   {k: v.sharding for k, v in b0.items()})
        m = step(js, b0)[0].opt.m
    else:
        tcfg = TC.get_tiny("yi-9b")
        tt = TST.TrainConfig(opt=TA.OptConfig(**opt),
                             compute_dtype=compute_dtype, **kw)
        ts = train_state_from_reference(jax.tree.map(np.asarray, js), tcfg,
                                        device="cpu")
        ts, _ = TST.make_train_step(tcfg, tt)(ts, to_device(hb, "cpu"))
        m = train_state_to_reference(ts).opt.m
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(m)])


@pytest.mark.parametrize("case", ["bf16", "bf16_accum2"])
def test_first_step_gradients_carry_the_reference_precision(case):
    kw = {k: v for k, v in CASES[case].items()}
    accum = kw.get("accum_steps", 1)
    g_port = _first_gradients("port", "bfloat16", kw)
    g_ref = _first_gradients("reference", "bfloat16", kw)
    g_f32 = _first_gradients("reference", "float32", kw)

    def bf16_values(g):
        g = torch.from_numpy(g * accum)
        return torch.equal(g, g.to(torch.bfloat16).to(torch.float32))

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    d_ref, d_port = rel(g_ref, g_f32), rel(g_port, g_f32)
    d_near = rel(g_port, g_ref)
    print(f"{case}: |g − g_f32|/|g_f32| reference bf16 {d_ref:.4g}, port "
          f"bf16 {d_port:.4g}; |g_port − g_ref|/|g_ref| {d_near:.4g} "
          f"against |g_f32 − g_ref|/|g_ref| {rel(g_f32, g_ref):.4g}")
    assert bf16_values(g_ref) and bf16_values(g_port)
    assert 0.5 * d_ref <= d_port <= 2 * d_ref
    assert d_near <= rel(g_f32, g_ref)


def test_train_loop_loss_decreases():
    """The contract of ``tests/test_system.py::
    test_train_loop_loss_decreases`` on the port: 30 steps on a fixed
    batch (memorisation) drop the loss by more than 0.5."""
    cfg = TC.get_tiny("yi-9b")
    tc = TST.TrainConfig(opt=TA.OptConfig(lr=5e-3, warmup_steps=5,
                                          total_steps=60))
    state, _ = TST.init_state(0, cfg, tc, device="cpu")
    step = TST.make_train_step(cfg, tc)
    batch0 = to_device(SyntheticLM(vocab=cfg.vocab, seq=32,
                                   global_batch=4).host_batch(0), "cpu")
    losses = []
    for _ in range(30):
        state, metrics = step(state, batch0)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::6]
    assert np.isfinite(losses).all()


def test_wider_mesh_raises_naming_its_item():
    """A mesh whose size is not the world's (one process here) raises a
    ``ValueError`` naming ``torchrun``; a (1, 1) mesh is one device."""
    cfg = TC.get_tiny("yi-9b")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node=2"):
        TST.make_train_step(cfg, TST.TrainConfig(), (2, 1))
    with pytest.raises(ValueError, match="torchrun --nproc-per-node=4"):
        TST.init_state(0, cfg, TST.TrainConfig(), (1, 4), device="cpu")
    TST.make_train_step(cfg, TST.TrainConfig(), (1, 1))
    state, shardings = TST.init_state(0, cfg, TST.TrainConfig(), (1, 1),
                                      device="cpu")
    assert shardings is None and int(state.step) == 0


def test_prefill_and_decode_steps_cast_like_the_train_step():
    """The serving steps run on the bf16 cast tree: prefill's last logits
    equal the model's forward on that tree, and one decode step after it
    gives logits of the right shape."""
    cfg = TC.get_tiny("yi-9b")
    tc = TST.TrainConfig()
    state, _ = TST.init_state(1, cfg, tc, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 9), dtype=np.int32))
    logits, caches = TST.make_prefill_step(cfg, tc)(state.params,
                                                    {"tokens": toks})
    with torch.no_grad():
        want, _ = state.params.prefill({"tokens": toks},
                                       params=state.params.tree(
                                           cast=torch.bfloat16))
    assert torch.equal(logits, want) and logits.dtype == torch.float32
    assert caches[0][0]["b0"]["k"].dtype == torch.bfloat16
    from repro_torch.models import pad_caches
    lg, _ = TST.make_decode_step(cfg, tc)(state.params, toks[:, :1],
                                          pad_caches(caches, 12), 9)
    assert lg.shape == (2, 1, cfg.vocab) and torch.isfinite(lg).all()
