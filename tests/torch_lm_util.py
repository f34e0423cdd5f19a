"""Shared inputs of the LM stack's CPU parity tests: numpy-seeded batches
for each frontend and reference parameters carried into the port."""

import contextlib
import dataclasses
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro import configs as JC
from repro.models import model as JM
from repro_torch import configs as TC
from repro_torch.convert import lm_from_reference

DENSE = ["yi-9b", "codeqwen1.5-7b", "gemma3-4b", "nemotron-4-340b",
         "hubert-xlarge", "phi-3-vision-4.2b"]
# MoE FFNs; deepseek's mixer is MLA, moonshot's GQA attention
MOE = ["deepseek-v2-lite-16b", "moonshot-v1-16b-a3b"]
# recurrent mixers: zamba2's Mamba2 blocks and its shared attention
# block, xlstm's mLSTM and sLSTM blocks
RECURRENT = ["zamba2-1.2b", "xlstm-350m"]
# what the port does not build yet, and the ROADMAP item each waits for
NON_DENSE: dict[str, str] = {}


def host_batch(cfg, b: int, s: int, seed: int) -> dict:
    """A random batch of ``cfg``'s frontend with sequence ``s``."""
    rng = np.random.default_rng(seed)
    ints = lambda shape: rng.integers(0, cfg.vocab, shape, dtype=np.int32)
    if cfg.frontend == "tokens":
        return {"tokens": ints((b, s)), "labels": ints((b, s))}
    if cfg.frontend == "frames":
        return {"frames": rng.standard_normal((b, s, cfg.d_frame))
                .astype(np.float32), "labels": ints((b, s))}
    st = s - cfg.n_img_tokens
    return {"tokens": ints((b, st)),
            "image_embeds": rng.standard_normal(
                (b, cfg.n_img_tokens, cfg.d_patch)).astype(np.float32),
            "labels": ints((b, st))}


def jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def carried(arch: str, seed: int = 0):
    """(reference cfg, port cfg, reference params, the port's LM holding
    the same parameters on the CPU)."""
    jc, tc = JC.get_tiny(arch), TC.get_tiny(arch)
    params, _ = JM.init_params(jax.random.PRNGKey(seed), jc)
    model = lm_from_reference(jax.tree.map(np.asarray, params), tc,
                              device="cpu")
    return jc, tc, params, model


def close_to(got, want, tol):
    """A tensor against a jax array within ``tol`` of the array's largest
    entry (rtol and atol alike)."""
    got = got.detach().float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def cast_tree(params, dtype=jnp.bfloat16):
    """The reference train step's compute-dtype cast."""
    return jax.tree.map(lambda x: x.astype(dtype)
                        if x.dtype == jnp.float32 and x.ndim > 1 else x,
                        params)


def with_capacity(cfg, factor: float):
    """``cfg`` (either package's) with every MoE block's
    ``capacity_factor`` set to ``factor``. 16.0 is dropless at the
    configs' group size 128 (cap = 128·k/e·16 ≥ 128 = g with margin)."""
    def blk(b):
        if b.moe is None:
            return b
        return dataclasses.replace(b, moe=dataclasses.replace(
            b.moe, capacity_factor=factor))
    return dataclasses.replace(cfg, segments=tuple(
        dataclasses.replace(seg, blocks=tuple(blk(b) for b in seg.blocks))
        for seg in cfg.segments))


@contextlib.contextmanager
def reference_routes():
    """Record the reference's routing while its ``moe_forward`` runs,
    jitted or scanned or not: ``jax.nn.one_hot`` is wrapped so that each
    call hands its index argument to the host (``jax.debug.callback``,
    ordered). Yields a list that receives, per MoE call, a dict of the
    call's ``topi`` (ng, g, k), ``keep`` and ``pos`` (ng, g, k; pos −1
    where dropped) and ``cap``."""
    calls, routes = [], []
    orig = jax.nn.one_hot

    def record(a, n):
        calls.append((np.asarray(a), n))
        if len(calls) < 1 + calls[0][0].shape[-1]:   # topi, then k slots
            return
        topi = calls[0][0]
        slot = np.stack([np.take_along_axis(c, topi[..., j:j + 1], -1)[..., 0]
                         for j, (c, _) in enumerate(calls[1:])], -1)
        routes.append({"topi": topi, "keep": slot >= 0, "pos": slot,
                       "cap": calls[1][1]})
        calls.clear()

    def wrapped(a, n, **kw):
        jax.debug.callback(lambda v: record(v, n), a, ordered=True)
        return orig(a, n, **kw)

    with mock.patch.object(jax.nn, "one_hot", wrapped):
        yield routes
    jax.effects_barrier()


def port_routes(t_layers):
    """A context recording the port's :func:`moe_route` results, one per
    MoE call, into a list it yields."""
    @contextlib.contextmanager
    def ctx():
        out = []
        orig = t_layers.moe_route

        def wrapped(params, spec, x):
            r = orig(params, spec, x)
            out.append(r)
            return r

        with mock.patch.object(t_layers, "moe_route", wrapped):
            yield out
    return ctx()


def route_flips(a, b, tokens: int) -> tuple[int, int]:
    """(pairs routed to another expert or kept otherwise, all pairs) of
    the first ``tokens`` tokens of one MoE call, each route a
    :func:`reference_routes` dict or the port's ``MoeRoute``."""
    def field(r, name):
        v = np.asarray(r[name] if isinstance(r, dict) else getattr(r, name))
        return v.reshape(-1, v.shape[-1])[:tokens]
    differ = ((field(a, "topi") != field(b, "topi"))
              | (field(a, "keep") != field(b, "keep")))
    return int(differ.sum()), differ.size
