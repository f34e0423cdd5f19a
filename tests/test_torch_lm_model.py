"""The LM stack's model and configs (``repro_torch.models.model``,
``repro_torch.configs``) against the reference's on the CPU, on the
reference's parameters carried over (``repro_torch.convert``):

* the ten configs equal field for field; the dense archs' parameter
  shapes equal ``init_params``'; every arch builds (none waits for a
  ROADMAP item), the recurrent ones with the reference's decode caches;
* ``forward_loss`` of the six dense tiny configs in f32 (rtol 1e-5) and
  in bf16 on the train step's cast tree (rtol 2e-3: the loss is a mean
  over bf16 hidden states);
* gradients against ``jax.grad`` (f32: max error ≤ 1e-4 of the leaf's
  largest entry), mapped through ``lm_params_to_reference``;
* ``prefill``/``decode_step`` against the reference's, and token-by-token
  decode against the full forward (the reference's
  ``test_decode_matches_forward`` contract, and 1e-4 in f32).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as JC
from repro.models import model as JM
from repro_torch import configs as TC
from repro_torch.convert import (lm_params_from_reference,
                                 lm_params_to_reference)
from repro_torch.models import LM, cache_init, pad_caches
from repro_torch.models import model as TM
from torch_lm_util import (DENSE, MOE, NON_DENSE, RECURRENT, carried,
                           cast_tree, host_batch, jax_batch, torch_batch)


def _as_dict(obj):
    """A config as nested plain data, each dataclass tagged with its class
    name (the packages' classes differ, their names and fields must not)."""
    if dataclasses.is_dataclass(obj):
        return {"__class__": type(obj).__name__,
                **{f.name: _as_dict(getattr(obj, f.name))
                   for f in dataclasses.fields(obj)}}
    if isinstance(obj, (tuple, list)):
        return [_as_dict(x) for x in obj]
    return obj


@pytest.mark.parametrize("arch", list(JC.ARCHS))
def test_configs_equal_reference(arch):
    assert list(TC.ARCHS) == list(JC.ARCHS)
    assert _as_dict(TC.get_config(arch)) == _as_dict(JC.get_config(arch))
    assert _as_dict(TC.get_tiny(arch)) == _as_dict(JC.get_tiny(arch))
    for shape in JC.SHAPES:
        assert TC.cell_skip_reason(arch, shape) == \
            JC.cell_skip_reason(arch, shape)
    assert TC.get_config(arch).n_layers == JC.get_config(arch).n_layers


def test_shapes_and_cells_equal_reference():
    assert {k: _as_dict(v) for k, v in TC.SHAPES.items()} == \
        {k: _as_dict(v) for k, v in JC.SHAPES.items()}
    assert TC.cells() == JC.cells()


@pytest.mark.parametrize("arch", DENSE)
def test_param_shapes_equal_reference(arch):
    params, _ = JM.init_params(jax.random.PRNGKey(0), JC.get_tiny(arch))
    model = LM(TC.get_tiny(arch), device="cpu")
    want = jax.tree.map(lambda a: tuple(a.shape), params)
    got = jax.tree.map(lambda a: tuple(a.shape),
                       lm_params_to_reference(model))
    assert got == want
    assert model.n_params() == sum(a.size for a in jax.tree.leaves(params))


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_archs_build_with_the_reference_caches(arch):
    """zamba2 and xlstm build (tiny on the CPU, full on "meta"), and their
    decode caches have the reference's keys, shapes and dtypes: the
    recurrent states f32 whatever the cache dtype, Mamba2's conv state in
    it, one attention cache per application of zamba2's shared block."""
    assert not NON_DENSE and sorted(DENSE + MOE + RECURRENT) == sorted(
        JC.ARCHS)
    for cfg in (TC.get_tiny(arch), TC.get_config(arch)):
        model = LM(cfg, device="cpu" if "tiny" in cfg.name else "meta")
        assert model.n_params() > 0
    jc, tc = JC.get_tiny(arch), TC.get_tiny(arch)
    jcaches, _ = JM.cache_init(jc, 2, 16, dtype=jnp.bfloat16)
    tcaches = cache_init(tc, 2, 16, dtype=torch.bfloat16, device="cpu")
    assert len(tcaches) == len(jcaches)
    for si, seg in enumerate(tcaches):
        assert len(seg) == tc.segments[si].repeat
        for layer in seg:
            assert sorted(layer) == sorted(jcaches[si])
            for b, c in layer.items():
                assert sorted(c) == sorted(jcaches[si][b])
                for n, t in c.items():
                    want = jcaches[si][b][n]
                    assert tuple(t.shape) == want.shape[1:]
                    assert str(t.dtype).split(".")[1] == str(want.dtype)
                    assert not t.any()


def test_converter_round_trip_is_exact():
    jc, tc, params, model = carried("gemma3-4b", seed=5)
    back = lm_params_to_reference(model)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    sd = lm_params_from_reference(back, tc, device="cpu")
    assert set(sd) == set(dict(model.named_parameters()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
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


@pytest.mark.parametrize("arch", DENSE)
def test_gradients_match_reference(arch):
    jc, tc, params, model = carried(arch, seed=3)
    batch = host_batch(jc, 2, 24, seed=4)
    want = jax.grad(lambda p: JM.forward_loss(
        p, jc, jax_batch(batch), compute_dtype=jnp.float32))(params)
    loss = model.forward_loss(torch_batch(batch), compute_dtype=torch.float32)
    names = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(names.values()), allow_unused=True)
    got = lm_params_to_reference(type("Grads", (), {
        "named_parameters": lambda self: [
            (k, torch.zeros_like(p) if g is None else g)
            for (k, p), g in zip(names.items(), grads)]})())
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(g - w).max() <= 1e-4 * scale


@pytest.mark.parametrize("arch", [a for a in DENSE
                                  if not JC.get_tiny(a).encoder_only])
def test_prefill_and_decode_match_reference(arch):
    jc, tc, params, model = carried(arch, seed=6)
    batch = host_batch(jc, 2, 20, seed=7)
    batch.pop("labels")
    jl, jcache = JM.prefill(params, jc, jax_batch(batch),
                            compute_dtype=jnp.float32)
    with torch.no_grad():
        tl, tcache = model.prefill(torch_batch(batch),
                                   compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jl)).max())
    for si, seg in enumerate(tcache):
        for li, layer in enumerate(seg):
            for b, c in layer.items():
                for n in ("k", "v"):
                    np.testing.assert_allclose(
                        c[n].numpy(), np.asarray(jcache[si][b][n][li]),
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


@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-4b", "codeqwen1.5-7b"])
def test_decode_matches_forward(arch):
    """Token-by-token decode, and prefill then decode, give the full
    forward's logits: the reference's contract (rtol 2e-2, atol 2e-2) and
    1e-4 of the logits' scale in f32."""
    tc = TC.get_tiny(arch)
    model = LM(tc, seed=3, device="cpu")
    s = 12
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tc.vocab, (1, s), dtype=np.int32))
    with torch.no_grad():
        tree = model.tree()
        x, pos, _ = TM._embed_inputs(tree, tc, {"tokens": toks},
                                     torch.float32)
        h, _ = TM.backbone(tree, tc, x, pos)
        full = TM.logits_for(tree, tc, h).numpy()
        caches = cache_init(tc, 1, s, dtype=torch.float32, device="cpu")
        outs = []
        for t in range(s):
            lg, caches = model.decode_step(toks[:, t:t + 1], caches, t,
                                           compute_dtype=torch.float32)
            outs.append(lg[:, 0].numpy())
        # prefill the first 8, then decode the last 4 from its caches
        _, pc = model.prefill({"tokens": toks[:, :8]},
                              compute_dtype=torch.float32)
        pc = pad_caches(pc, s)
        tail = []
        for t in range(8, s):
            lg, pc = model.decode_step(toks[:, t:t + 1], pc, t,
                                       compute_dtype=torch.float32)
            tail.append(lg[:, 0].numpy())
    dec = np.stack(outs, axis=1)
    np.testing.assert_allclose(dec, full, rtol=2e-2, atol=2e-2)
    scale = np.abs(full).max()
    assert np.abs(dec - full).max() <= 1e-4 * scale
    assert np.abs(np.stack(tail, axis=1) - full[:, 8:]).max() <= 1e-4 * scale


def test_remat_gives_the_same_loss_and_gradients():
    """Layer and loss-chunk checkpointing change no number."""
    tc = dataclasses.replace(TC.get_tiny("yi-9b"), loss_chunk=8)
    batch = torch_batch(host_batch(tc, 2, 20, seed=1))
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(tc, remat=remat)
        model = LM(cfg, seed=2, device="cpu")
        loss = model.forward_loss(batch, compute_dtype=torch.float32)
        loss.backward()
        out.append((float(loss), [p.grad.clone() for p in model.parameters()]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
