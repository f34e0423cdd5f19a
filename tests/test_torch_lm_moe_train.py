"""The MoE/MLA architectures through the train step, checkpoints and the
training entry point on the CPU:

* the port's ``make_train_step`` against the reference's on the
  auto-typed 1×1 mesh (see ``test_torch_lm_train.py`` for why), tiny
  deepseek-v2-lite (MLA + MoE), 3 steps from the same parameters on the
  same ``SyntheticLM`` batches, with ``test_torch_lm_train.py``'s cases.
  f32 compute with f32 gradients, its limits: the same routes, losses to
  rtol 1e-5, the parameters within atol 1e-5 + rtol 1e-4 but for at most
  0.1 % of the entries, none further than 2·lr, the update within 1e-3.
  bf16 (one microbatch, and ``accum_steps=2``): losses to rtol 1e-3, and
  the update and the routes within the reference's own bf16-to-f32
  distance (see the test). Each case prints the (token, choice) pairs
  whose expert or keep differs between the packages on step 0's forward
  (its cast tree and batch), for each MoE layer;
* a MoE/MLA ``TrainState`` (random moments, so that every leaf differs)
  through a reference checkpoint into the port and a port checkpoint
  into the reference, leaf for leaf, the router and the 3-D expert
  stacks included;
* ``python -m repro_torch.launch.train --arch A --tiny`` for both MoE
  architectures, from a fresh start and resumed from its checkpoint.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from repro import checkpoint as jckpt
from repro import configs as JC
from repro.data import device_batch
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.train import steps as JST
from repro_torch import checkpoint as tckpt
from repro_torch import configs as TC
from repro_torch.convert import (train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.data import SyntheticLM, to_device
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA
from repro_torch.train import steps as TST
from torch_lm_util import (MOE, cast_tree, port_routes, reference_routes,
                           route_flips, torch_batch)

ARCH = "deepseek-v2-lite-16b"
LR = 5e-3
CASES = {
    "f32_fp32_grads": dict(compute_dtype="float32", fp32_grads=True),
    "bf16": dict(),
    "bf16_accum2": dict(accum_steps=2),
}


def _auto_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _routes(pkg, params, cfg, micro: dict, bf16: bool) -> list:
    """``pkg``'s routes of every MoE layer on a forward of ``micro`` (the
    train step's cast tree in bf16): reference dicts or ``MoeRoute``s."""
    if pkg == "reference":
        dt = jnp.bfloat16 if bf16 else jnp.float32
        with reference_routes() as out:
            JM.forward_loss(cast_tree(params, dt) if bf16 else params, cfg,
                            {k: jnp.asarray(v) for k, v in micro.items()},
                            compute_dtype=dt)
    else:
        dt = torch.bfloat16 if bf16 else torch.float32
        with port_routes(TL) as out, torch.no_grad():
            TM.forward_loss(params.tree(cast=dt if bf16 else None), cfg,
                            torch_batch(micro), compute_dtype=dt)
    assert len(out) == sum(seg.repeat for seg in cfg.segments
                           if seg.blocks[0].moe is not None)
    return out


def _flips(a: list, b: list, tokens: int) -> list[int]:
    return [route_flips(x, y, tokens)[0] for x, y in zip(a, b)]


def _reference_run(case, mesh, src):
    """The reference's state before (host arrays) and after 3 steps of
    ``case``, and its losses."""
    jt = JST.TrainConfig(opt=JA.OptConfig(lr=LR, warmup_steps=2,
                                          total_steps=60), **CASES[case])
    js, jsh = JST.init_state(jax.random.PRNGKey(0), JC.get_tiny(ARCH), jt,
                             mesh)
    b0 = device_batch(mesh, src.host_batch(0))
    step = JST.make_train_step(JC.get_tiny(ARCH), jt, mesh, jsh,
                               {k: v.sharding for k, v in b0.items()})
    start, losses = jax.tree.map(np.array, js), []   # the step donates js
    for i in range(3):
        js, m = step(js, device_batch(mesh, src.host_batch(i)))
        losses.append(float(m["loss"]))
    return start, js, losses


def _update(state, start) -> np.ndarray:
    return np.concatenate([(np.asarray(w) - np.asarray(z)).ravel()
                           for w, z in zip(jax.tree.leaves(state.params),
                                           jax.tree.leaves(start.params))])


@pytest.fixture(scope="module")
def reference_f32():
    """The reference's f32 run (the f32 case, and the yardstick of the
    bf16 cases)."""
    return _reference_run("f32_fp32_grads", _auto_mesh(),
                          SyntheticLM(vocab=256, seq=32, global_batch=4))


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference(case, reference_f32):
    """bf16: an expert that receives a token in one package and not in the
    other gets another gradient, and Adam's first steps move it by ±lr
    either way, so the limits are the reference's own bf16 noise: the
    port's update lies no further from the reference's bf16 update than
    that lies from the reference's f32 update (0.41 and 0.59 relative on
    this setup, against 0.082 on the dense yi-9b), and the port's bf16
    routes differ from the reference's bf16 routes in no more pairs than
    those differ from its f32 routes (the step-0 forward, every MoE
    layer)."""
    kw = CASES[case]
    bf16 = kw.get("compute_dtype", "bfloat16") == "bfloat16"
    mesh = _auto_mesh()
    jc, tcfg = JC.get_tiny(ARCH), TC.get_tiny(ARCH)
    tt = TST.TrainConfig(opt=TA.OptConfig(lr=LR, warmup_steps=2,
                                          total_steps=60), **kw)
    src = SyntheticLM(vocab=jc.vocab, seq=32, global_batch=4)
    js0, js, jl = (reference_f32 if case == "f32_fp32_grads"
                   else _reference_run(case, mesh, src))
    ts = train_state_from_reference(js0, tcfg, device="cpu")
    hb = src.host_batch(0)
    micro = {k: v[:v.shape[0] // kw.get("accum_steps", 1)]
             for k, v in hb.items()}
    tokens = micro["tokens"].size
    ref_routes = _routes("reference", js0.params, jc, micro, bf16)
    flips = _flips(ref_routes, _routes("port", ts.params, tcfg, micro, bf16),
                   tokens)
    tstep = TST.make_train_step(tcfg, tt)
    tl = []
    for i in range(3):
        ts, tm = tstep(ts, to_device(src.host_batch(i), "cpu"))
        tl.append(float(tm["loss"]))
    assert int(ts.step) == int(js.step) == 3
    want = [np.asarray(x) for x in jax.tree.leaves(js.params)]
    got = jax.tree.leaves(train_state_to_reference(ts).params)
    err = np.concatenate([np.abs(g - w).ravel() for g, w in zip(got, want)])
    lim = np.concatenate([(1e-5 + 1e-4 * np.abs(w)).ravel() for w in want])
    outside = int((err > lim).sum())
    dw = _update(js, js0)
    dg = np.concatenate([(g - np.asarray(z)).ravel() for g, z in zip(
        got, jax.tree.leaves(js0.params))])
    rel = np.linalg.norm(dg - dw) / np.linalg.norm(dw)
    cos = dg @ dw / np.linalg.norm(dg) / np.linalg.norm(dw)
    pairs = tokens * tcfg.segments[-1].blocks[0].moe.top_k
    print(f"{case}: pairs routed otherwise than the reference on step 0 "
          f"per MoE layer {flips} of {pairs}; "
          f"losses {tl} vs {jl}; {outside} of {err.size} entries outside "
          f"atol 1e-5 + rtol 1e-4 (max {err.max():.3g}); update relative "
          f"error {rel:.3g}, cosine {cos:.6f}")
    if not bf16:
        assert flips == [0] * len(flips)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert outside <= 1e-3 * err.size and err.max() <= 2 * LR
        assert rel <= 1e-3
        return
    d32 = _update(reference_f32[1], reference_f32[0])
    noise = np.linalg.norm(dw - d32) / np.linalg.norm(d32)
    ref_flips = _flips(ref_routes, _routes("reference", js0.params, jc,
                                           micro, False), tokens)
    print(f"  the reference's bf16 against its f32: update {noise:.3g}, "
          f"routes {ref_flips}")
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert rel <= noise and sum(flips) <= sum(ref_flips)


def test_checkpoints_cross_between_packages(tmp_path):
    cfg, jc = TC.get_tiny(ARCH), JC.get_tiny(ARCH)
    js, _ = JST.init_state(jax.random.PRNGKey(1), jc, JST.TrainConfig(),
                           _auto_mesh())
    rng = np.random.default_rng(2)
    fill = lambda t: jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), a.dtype), t)
    jstate = js._replace(opt=js.opt._replace(m=fill(js.opt.m),
                                             v=fill(js.opt.v)),
                         step=jnp.asarray(7, jnp.int32))
    want = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    # reference → port
    jckpt.save(str(tmp_path / "j"), 7, jstate)
    like = train_state_to_reference(TST.init_state(
        5, cfg, TST.TrainConfig(), device="cpu")[0])
    tree, _ = tckpt.restore(str(tmp_path / "j"), 7, like, device="cpu")
    port = train_state_from_reference(tree, cfg, device="cpu")
    got = jax.tree.leaves(train_state_to_reference(port))
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(w, g)
    ffn = port.params.segments[-1][0]["b0"].ffn
    assert ffn.router.dtype == torch.float32 and ffn.w_in.dim() == 3
    # port → reference
    tckpt.save(str(tmp_path / "t"), 7, train_state_to_reference(port))
    back, _ = jckpt.restore(str(tmp_path / "t"), 7, jstate)
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    for w, g in zip(want, jax.tree.leaves(back)):
        np.testing.assert_array_equal(w, np.asarray(g))


@pytest.mark.parametrize("arch", MOE)
def test_train_cli_runs_and_resumes(arch, tmp_path, capsys):
    argv = ["--arch", arch, "--tiny", "--seq", "16", "--batch", "2",
            "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    _, first = launch_train.main(argv + ["--steps", "2"])
    state, rest = launch_train.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "tok/s" in out
    assert list(first) == [0, 1] and list(rest) == [2]
    assert np.isfinite(list(first.values()) + list(rest.values())).all()
    assert int(state.step) == 3 and tckpt.latest_step(str(tmp_path)) == 3
