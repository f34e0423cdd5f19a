"""Shared inputs of the LM stack's CPU parity tests: numpy-seeded batches
for each frontend and reference parameters carried into the port."""

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
NON_DENSE = {"deepseek-v2-lite-16b": "14b", "moonshot-v1-16b-a3b": "14b",
             "zamba2-1.2b": "14c", "xlstm-350m": "14c"}


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


def cast_tree(params, dtype=jnp.bfloat16):
    """The reference train step's compute-dtype cast."""
    return jax.tree.map(lambda x: x.astype(dtype)
                        if x.dtype == jnp.float32 and x.ndim > 1 else x,
                        params)
