"""The MoE FFN (``repro_torch.models.layers.moe_forward``) and the two MoE
architectures (deepseek-v2-lite-16b: MLA + MoE; moonshot-v1-16b-a3b: GQA
+ MoE) against the reference on the CPU, on the same numpy-seeded inputs
and the reference's parameters carried over (``convert``):

* ``moe_forward`` at the tiny configs' widths (8 experts, top-2, one
  shared expert) in f32 and bf16, in one group, at ``capacity_factor``
  0.5 (pairs dropped) and over 200 tokens (two groups of 128, 56 padded):
  the kept (token, choice) pairs, their experts and slots equal the
  reference's exactly (read from the reference's own ``one_hot`` calls),
  and the outputs agree to rtol 1e-5 of the output's scale in f32 and
  2e-2 in bf16 (test_torch_lm_layers.py's limits); its gradients, the
  router's through the kept weights included, to 1e-4 of each leaf's
  largest entry;
* the models: parameter shapes and dtypes (the router f32 in a bf16
  model), the full configs' 15.5 B and 28.6 B parameters' shapes built on
  the "meta" device against ``jax.eval_shape`` of ``init_params``, the
  converter round trip bit for bit, ``forward_loss`` in f32 (rtol 1e-5)
  and bf16 on the cast tree (2e-3), gradients against ``jax.grad``
  (1e-4 of each leaf's largest), and remat recomputing the same routes
  (loss and gradients bit for bit with and without checkpointing).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as JC
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import configs as TC
from repro_torch.convert import (lm_params_from_reference,
                                 lm_params_to_reference)
from repro_torch.models import LM
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from torch_lm_util import (MOE, carried, cast_tree, close_to, host_batch,
                           jax_batch, port_routes, reference_routes,
                           torch_batch)

F32_TOL = 1e-5
BF16_TOL = 2e-2

# (batch, sequence, capacity_factor) of x for moe_forward
MOE_CASES = {
    "one_group": (2, 40, 1.25),     # 80 tokens, cap 25
    "drops": (2, 40, 0.5),          # cap 10 against 20 pairs an expert
    "padded": (2, 100, 1.25),       # 200 tokens: 2 groups of 128, 56 padded
}


def _specs(factor: float):
    """The tiny configs' MoE spec in both packages (deepseek's and
    moonshot's are the same) at ``factor``."""
    pick = lambda cfg: dataclasses.replace(
        cfg.segments[-1].blocks[0].moe, capacity_factor=factor)
    return pick(JC.get_tiny(MOE[0])), pick(TC.get_tiny(MOE[0]))


def _port_tree(jparams, dtype):
    """The reference's MoE parameters as the port's tree, cast as the
    train step casts (every f32 leaf with ndim > 1, the router too)."""
    def leaf(v):
        t = torch.from_numpy(np.array(v, np.float32))
        return t.to(dtype) if t.dim() > 1 else t
    return jax.tree.map(leaf, jparams)


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_matches_reference(case, dtype):
    b, s, factor = MOE_CASES[case]
    jspec, tspec = _specs(factor)
    jp, _ = JL.moe_init(jax.random.PRNGKey(11), jspec)
    x = np.random.default_rng(12).standard_normal(
        (b, s, jspec.d_model)).astype(np.float32)
    if dtype == "bfloat16":
        jp = cast_tree(jp)
        jx = jnp.asarray(x, jnp.bfloat16)
        tdt = torch.bfloat16
    else:
        jx, tdt = jnp.asarray(x), torch.float32
    tp = _port_tree(jp, tdt)
    tx = torch.from_numpy(x).to(tdt)
    with reference_routes() as jroutes:
        want = JL.moe_forward(jp, jspec, jx)
    with port_routes(TL) as troutes:
        got = TL.moe_forward(tp, tspec, tx)
    assert len(jroutes) == len(troutes) == 1
    jr, tr = jroutes[0], troutes[0]
    t = b * s
    real = lambda a: np.asarray(a).reshape(-1, jspec.top_k)[:t]
    kept = real(tr.keep)
    dropped = int((~kept).sum())
    print(f"{case} {dtype}: cap {tr.cap}, groups {tuple(tr.topi.shape[:2])}, "
          f"{dropped} of {kept.size} pairs dropped")
    assert tr.cap == jr["cap"] and tr.tokens == t
    np.testing.assert_array_equal(real(tr.topi), real(jr["topi"]))
    np.testing.assert_array_equal(kept, real(jr["keep"]))
    np.testing.assert_array_equal(np.where(kept, real(tr.pos), -1),
                                  real(jr["pos"]))
    if case == "drops":
        assert dropped > 0
    if case == "padded":
        assert tuple(tr.topi.shape[:2]) == (2, 128)
    assert got.dtype == tdt and got.shape == tx.shape
    close_to(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


def test_moe_gradients_match_reference():
    """f32, with dropped pairs: the gradients of Σ w·moe_forward(x) with
    respect to every parameter (the router's through the kept weights)
    and to x."""
    jspec, tspec = _specs(0.5)
    jp, _ = JL.moe_init(jax.random.PRNGKey(13), jspec)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 40, jspec.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    jg = jax.grad(lambda p, x: jnp.sum(JL.moe_forward(p, jspec, x) * w),
                  argnums=(0, 1))(jp, jnp.asarray(x))
    tp = jax.tree.map(lambda v: torch.from_numpy(np.array(v))
                      .requires_grad_(), jp)
    tx = torch.from_numpy(x).requires_grad_()
    loss = torch.sum(TL.moe_forward(tp, tspec, tx) * torch.from_numpy(w))
    leaves = jax.tree.leaves(tp) + [tx]
    tg = torch.autograd.grad(loss, leaves)
    for want, got in zip(jax.tree.leaves(jg), tg):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def _by_port_name(tree) -> dict:
    """The reference's parameter tree (arrays or shape structs) as {the
    port's parameter name: (shape, dtype name)}, each segment's stacked
    leaf unstacked per layer."""
    out = {}

    def walk(node, prefix, seg):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.", seg)
            elif seg is None:
                out[f"{prefix}{k}"] = (tuple(v.shape), str(v.dtype))
            else:
                for li in range(v.shape[0]):
                    out[f"segments.{seg}.{li}.{prefix}{k}"] = (
                        tuple(v.shape[1:]), str(v.dtype))

    walk({k: v for k, v in tree.items() if k != "segments"}, "", None)
    for si, seg in enumerate(tree["segments"]):
        walk(seg, "", si)
    return out


def _port_leaves(model) -> dict:
    return {k: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
            for k, p in model.named_parameters()}


@pytest.mark.parametrize("arch", MOE)
def test_param_shapes_and_dtypes_equal_reference(arch):
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        params, _ = JM.init_params(jax.random.PRNGKey(0), JC.get_tiny(arch),
                                   dtype=jdt)
        model = LM(TC.get_tiny(arch), device="cpu", dtype=tdt)
        assert _port_leaves(model) == _by_port_name(params)
        assert model.n_params() == sum(a.size
                                       for a in jax.tree.leaves(params))
    router = model.segments[-1][0]["b0"].ffn.router
    assert router.dtype == torch.float32       # kept f32 in a bf16 model


@pytest.mark.parametrize("arch", MOE)
def test_full_config_shapes_equal_reference(arch):
    """The published config's parameter shapes, without their memory: the
    port built on the "meta" device, the reference under eval_shape."""
    jc, tc = JC.get_config(arch), TC.get_config(arch)
    want = _by_port_name(jax.eval_shape(
        lambda: JM.init_params(jax.random.PRNGKey(0), jc)[0]))
    model = LM(tc, device="meta")
    assert _port_leaves(model) == want
    n = model.n_params()
    print(f"{arch}: {n:,} parameters")
    assert n == sum(int(np.prod(s)) for s, _ in want.values())


@pytest.mark.parametrize("arch", MOE)
def test_converter_round_trip_is_exact(arch):
    jc, tc, params, model = carried(arch, seed=5)
    back = lm_params_to_reference(model)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        a = np.asarray(a)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    sd = lm_params_from_reference(back, tc, device="cpu")
    assert set(sd) == set(dict(model.named_parameters()))
    for k, p in model.named_parameters():
        assert torch.equal(sd[k], p.detach())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_forward_loss_matches_reference(arch, dtype):
    jc, tc, params, model = carried(arch, seed=1)
    batch = host_batch(jc, 2, 40, seed=2)
    if dtype == "float32":
        want = JM.forward_loss(params, jc, jax_batch(batch),
                               compute_dtype=jnp.float32)
        got = model.forward_loss(torch_batch(batch),
                                 compute_dtype=torch.float32)
        tol = 1e-5
    else:
        want = JM.forward_loss(cast_tree(params), jc, jax_batch(batch),
                               compute_dtype=jnp.bfloat16)
        got = TM.forward_loss(model.tree(cast=torch.bfloat16), tc,
                              torch_batch(batch),
                              compute_dtype=torch.bfloat16)
        tol = 2e-3
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=tol)


@pytest.mark.parametrize("arch", MOE)
def test_gradients_match_reference(arch):
    jc, tc, params, model = carried(arch, seed=3)
    batch = host_batch(jc, 2, 24, seed=4)
    want = jax.grad(lambda p: JM.forward_loss(
        p, jc, jax_batch(batch), compute_dtype=jnp.float32))(params)
    loss = model.forward_loss(torch_batch(batch), compute_dtype=torch.float32)
    names = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(names.values()))
    got = lm_params_to_reference(type("Grads", (), {
        "named_parameters": lambda self: list(zip(names, grads))})())
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(g - w).max() <= 1e-4 * scale


def test_remat_routes_identically():
    """Checkpointed layers recompute the same routes: the loss and every
    gradient equal the run without checkpointing bit for bit, in bf16 on
    the cast tree."""
    tc = TC.get_tiny("deepseek-v2-lite-16b")
    batch = torch_batch(host_batch(tc, 2, 40, seed=1))
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(tc, remat=remat)
        model = LM(cfg, seed=2, device="cpu")
        loss = TM.forward_loss(model.tree(cast=torch.bfloat16), cfg, batch)
        loss.backward()
        out.append((float(loss), [p.grad.clone() for p in model.parameters()]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
