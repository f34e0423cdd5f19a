"""The recurrent architectures (zamba2: Mamba2 blocks and one shared
attention + FFN block; xlstm: mLSTM and sLSTM blocks) in
``repro_torch.models.model`` against the reference's on the CPU, on the
reference's parameters carried over (``repro_torch.convert``):

* the parameter tree: the tiny configs' shapes and dtypes equal
  ``init_params``', the shared block's parameters once at ``shared`` and
  in no layer; the full configs' parameter counts (``device="meta"``)
  equal the reference's ``jax.eval_shape`` count; the converter's round
  trip is exact;
* ``forward_loss`` in f32 (rtol 1e-5) and in bf16 on the train step's
  cast tree (rtol 2e-3); gradients against ``jax.grad`` (f32: max error
  ≤ 1e-4 of the leaf's largest entry), the shared leaf's included;
* decode: token by token from empty caches against the reference's
  decode (1e-4 of the logits' scale, f32); prefill, ``pad_caches`` and
  decode against the reference's prefill and decode (zamba2's attention
  caches padded on their sequence axis, the recurrent states as they
  are); token by token against the full forward (the reference's
  ``test_decode_matches_forward`` contract). xlstm's prefill+decode is
  held to the reference's prefill+decode, not to the forward: its mLSTM
  stabiliser scales a prefill's state, in the reference too;
* ``pad_caches`` passes every recurrent state through, and block remat
  changes no number.
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
from torch_lm_util import (RECURRENT, carried, cast_tree, close_to,
                           host_batch, jax_batch, torch_batch)

# the reference's parameter counts of the full configs (jax.eval_shape)
FULL_PARAMS = {"zamba2-1.2b": 1_104_777_344, "xlstm-350m": 388_529_236}


def _shape_dtype(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(np.dtype(a.dtype))),
                        tree)


@pytest.mark.parametrize("arch", RECURRENT)
def test_param_shapes_and_dtypes_equal_reference(arch):
    params, _ = JM.init_params(jax.random.PRNGKey(0), JC.get_tiny(arch))
    model = LM(TC.get_tiny(arch), device="cpu")
    assert _shape_dtype(lm_params_to_reference(model)) == \
        _shape_dtype(params)
    assert model.n_params() == sum(a.size for a in jax.tree.leaves(params))
    cfg = TC.get_tiny(arch)
    shared = [bi for seg in cfg.segments for bi, b in enumerate(seg.blocks)
              if b.shared]
    assert hasattr(model, "shared") == bool(shared)
    for seg in model.segments:
        for layer in seg:
            assert not any(f"b{bi}" in layer for bi in shared)


@pytest.mark.parametrize("arch", RECURRENT)
def test_full_config_parameter_count_equals_reference(arch):
    want = sum(a.size for a in jax.tree.leaves(jax.eval_shape(
        lambda: JM.init_params(jax.random.PRNGKey(0),
                               JC.get_config(arch))[0])))
    got = LM(TC.get_config(arch), device="meta").n_params()
    assert got == want == FULL_PARAMS[arch]


@pytest.mark.parametrize("arch", RECURRENT)
def test_converter_round_trip_is_exact(arch):
    jc, tc, params, model = carried(arch, seed=5)
    back = lm_params_to_reference(model)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    sd = lm_params_from_reference(back, tc, device="cpu")
    assert set(sd) == set(dict(model.named_parameters()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", RECURRENT)
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


def _grads_as_reference(model, loss):
    names = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(names.values()),
                                allow_unused=True)
    return lm_params_to_reference(type("Grads", (), {
        "named_parameters": lambda self: [
            (k, torch.zeros_like(p) if g is None else g)
            for (k, p), g in zip(names.items(), grads)]})())


@pytest.mark.parametrize("arch", RECURRENT)
def test_gradients_match_reference(arch):
    """Every leaf, the shared block's too: its gradient is the sum over
    its applications, in both packages."""
    jc, tc, params, model = carried(arch, seed=3)
    batch = host_batch(jc, 2, 24, seed=4)
    want = jax.grad(lambda p: JM.forward_loss(
        p, jc, jax_batch(batch), compute_dtype=jnp.float32))(params)
    got = _grads_as_reference(model, model.forward_loss(
        torch_batch(batch), compute_dtype=torch.float32))
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(g - w).max() <= 1e-4 * scale
    if "shared" in want:
        assert any(np.abs(np.asarray(g)).max() > 0
                   for g in jax.tree.leaves(got["shared"]))


def _decode_tokens(tc, model, toks, caches, start):
    out = []
    with torch.no_grad():
        for t in range(start, toks.shape[1]):
            lg, caches = model.decode_step(
                torch.from_numpy(toks[:, t:t + 1]), caches, t,
                compute_dtype=torch.float32)
            out.append(lg[:, 0].numpy())
    return np.stack(out, 1), caches


def _reference_decode(params, jc, toks, caches, start):
    out = []
    for t in range(start, toks.shape[1]):
        lg, caches = JM.decode_step(params, jc, jnp.asarray(toks[:, t:t + 1]),
                                    caches, jnp.asarray(t),
                                    compute_dtype=jnp.float32)
        out.append(np.asarray(lg)[:, 0])
    return np.stack(out, 1), caches


def _assert_caches_close(tcache, jcache):
    for si, seg in enumerate(tcache):
        for li, layer in enumerate(seg):
            for b, c in layer.items():
                assert sorted(c) == sorted(jcache[si][b])
                for n, t in c.items():
                    want = np.asarray(jcache[si][b][n][li])
                    assert tuple(t.shape) == want.shape and \
                        t.dtype == torch.float32
                    np.testing.assert_allclose(
                        t.numpy(), want, rtol=1e-5,
                        atol=1e-5 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_matches_reference_token_by_token(arch):
    """12 tokens from empty caches: every step's logits and the final
    caches (the shared block's one cache per application)."""
    jc, tc, params, model = carried(arch, seed=6)
    toks = np.random.default_rng(7).integers(0, jc.vocab, (2, 12),
                                             dtype=np.int32)
    jcache, _ = JM.cache_init(jc, 2, 12, dtype=jnp.float32)
    want, jcache = _reference_decode(params, jc, toks, jcache, 0)
    got, tcache = _decode_tokens(
        tc, model, toks, cache_init(tc, 2, 12, dtype=torch.float32,
                                    device="cpu"), 0)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    _assert_caches_close(tcache, jcache)


@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_then_decode_matches_reference(arch):
    """Prefill 8 tokens, ``pad_caches`` to 12, decode the last 4, against
    the reference's prefill (logits and every cache) and its decode from
    its own caches, the attention caches padded on their sequence axis.
    zamba2 also equals its full forward; xlstm does not, in either
    package (the mLSTM stabiliser)."""
    jc, tc, params, model = carried(arch, seed=8)
    s, p = 12, 8
    toks = np.random.default_rng(9).integers(0, jc.vocab, (1, s),
                                             dtype=np.int32)
    jl, jcache = JM.prefill(params, jc, {"tokens": jnp.asarray(toks[:, :p])},
                            compute_dtype=jnp.float32)
    with torch.no_grad():
        tl, tcache = model.prefill({"tokens": torch.from_numpy(toks[:, :p])},
                                   compute_dtype=torch.float32)
    close_to(tl, jl, 1e-4)
    _assert_caches_close(tcache, jcache)
    jcache = [{b: {n: (jnp.pad(a, [(0, 0)] * (a.ndim - 2)
                               + [(0, s - p), (0, 0)])
                       if set(c) == {"k", "v"} else a)
                   for n, a in c.items()} for b, c in seg.items()}
              for seg in jcache]
    want, _ = _reference_decode(params, jc, toks, jcache, p)
    got, _ = _decode_tokens(tc, model, toks, pad_caches(tcache, s), p)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    if arch == "zamba2-1.2b":
        full = _full_logits(model, tc, toks)[:, p:]
        assert np.abs(got - full).max() <= 1e-4 * np.abs(full).max()


def _full_logits(model, cfg, toks):
    with torch.no_grad():
        tree = model.tree()
        x, pos, _ = TM._embed_inputs(
            tree, cfg, {"tokens": torch.from_numpy(toks)}, torch.float32)
        h, _ = TM.backbone(tree, cfg, x, pos)
        return TM.logits_for(tree, cfg, h).numpy()


@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_matches_forward(arch):
    """Token-by-token decode from empty caches gives the full forward's
    logits: the reference's contract (rtol 2e-2, atol 2e-2) and 1e-4 of
    the logits' scale in f32."""
    tc = TC.get_tiny(arch)
    model = LM(tc, seed=3, device="cpu")
    toks = np.random.default_rng(4).integers(0, tc.vocab, (1, 12),
                                             dtype=np.int32)
    full = _full_logits(model, tc, toks)
    dec, _ = _decode_tokens(tc, model, toks, cache_init(
        tc, 1, 12, dtype=torch.float32, device="cpu"), 0)
    np.testing.assert_allclose(dec, full, rtol=2e-2, atol=2e-2)
    assert np.abs(dec - full).max() <= 1e-4 * np.abs(full).max()


def test_pad_caches_passes_recurrent_states_through():
    """zamba2's prefill caches: the shared block's attention caches grow
    to ``smax`` on their sequence axis; every Mamba2 state (whose axis −2
    is d_state or the conv taps) and every xlstm state keeps its shape
    and its very tensor."""
    for arch in RECURRENT:
        tc = TC.get_tiny(arch)
        model = LM(tc, seed=1, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, tc.vocab, (2, 7), dtype=np.int32))
        with torch.no_grad():
            _, caches = model.prefill({"tokens": toks},
                                      compute_dtype=torch.float32)
        padded = pad_caches(caches, 16)
        kinds = set()
        for seg, pseg in zip(caches, padded):
            for layer, player in zip(seg, pseg):
                for b, c in layer.items():
                    kinds.add(frozenset(c))
                    for n, t in c.items():
                        if set(c) == {"k", "v"}:
                            assert t.shape[-2] == 7
                            assert player[b][n].shape == (
                                *t.shape[:-2], 16, t.shape[-1])
                            assert torch.equal(player[b][n][..., :7, :], t)
                        else:
                            assert player[b][n] is t
        want = ({frozenset({"ssm", "conv"}), frozenset({"k", "v"})}
                if arch == "zamba2-1.2b" else
                {frozenset({"h"}), frozenset({"h", "c", "n", "m"})})
        assert kinds == want


def test_block_remat_gives_the_same_loss_and_gradients():
    """Checkpointing each block (the shared one, applied twice, too)
    changes no number."""
    base = TC.get_tiny("zamba2-1.2b")
    batch = torch_batch(host_batch(base, 2, 20, seed=1))
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(base, remat=remat)
        model = LM(cfg, seed=2, device="cpu")
        loss = model.forward_loss(batch, compute_dtype=torch.float32)
        loss.backward()
        out.append((float(loss.detach()),
                    [p.grad.clone() for p in model.parameters()]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
