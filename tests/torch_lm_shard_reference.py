"""The reference's own sharded steps, for tests/test_torch_lm_shard.py
and tests/test_torch_ssm_split.py.

    python tests/torch_lm_shard_reference.py OUT.npz INIT.npz ARCH [PART]

runs in a process of its own, which sets ``XLA_FLAGS=
--xla_force_host_platform_device_count=4`` before importing JAX, the
reference's ``init_state(PRNGKey(0), ..., mesh)`` and its steps on
auto-typed meshes ``Mesh(devices.reshape(shape), ("data", "model"))``
(``jax.make_mesh`` makes explicit axes, on which the reference's
``jnp.take`` raises). ``make_train_step`` for 3 steps (lr 5e-3,
SyntheticLM batches of 4 × 32): (1, 1) in bf16, (2, 2) and (1, 4) in
bf16 and in f32 with f32 gradients, (4, 1) in f32 for the dense and MoE
models, (1, 1) in f32 for the recurrent one; each bf16 run also gives
its first step's gradient (``"first|m"``, the port's β₁ = 0 first
moment), its first moment unscaled by (1 − β₁) and the clip's factor.
For tiny yi-9b (attention caches cut over
the sequence), ARCH ``"kv16"`` (``dense_lm`` with 16 kv heads, whose
caches cut their heads; no train step) and tiny deepseek-v2-lite-16b
(MLA latent caches cut over positions), each (prefill, smax) of
``W.REF_DECODE``: ``make_prefill_step`` of 24 or 27 tokens, the caches
padded to smax (32; deepseek also 24 to 33, a whole latent cache) and
placed in ``cache_init``'s layouts, then ``make_decode_step`` to smax,
in f32 and bf16, on (1, 4); for each of ``W.ROUTE_TIES`` the bf16 runs
on (1, 1) too. Each of ``W.F32_ONLY`` (tiny moonshot-v1-16b-a3b)
trains in f32 on its mesh alone. PART ``"ssm"`` runs
tests/test_torch_ssm_split.py's set instead: ``W.SSM_TRAIN`` (tiny
xlstm-350m) in f32 on (1, 1), (1, 2), (2, 2) and (1, 4), and each
(prefill, smax) of ``W.SSM_DECODE[ARCH]`` (tiny zamba2-1.2b and
xlstm-350m: the recurrent states kept as prefill leaves them, the
attention caches padded) in f32 and bf16 on (1, 4) and in bf16 on
(1, 1). Each run compiles
for 5–10 s, so the
set is kept to what the test reads. It first writes INIT.npz, the
initial parameters under the port's names (where every port arm of the
test starts), then OUT.npz: per train run, the losses and the
parameters after the run as one vector in the port's parameter order
(``"<shape>|<mode>|losses"``, ``"...|params"``;
``"<shape>|bf16|first|m"``), per serve run the logits
(``"<shape>|serve|<mode>|<prefill>|<smax>"``, (4, smax − prefill + 1,
vocab)).
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_lm_shard_worker as W  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro import pshard as JSH  # noqa: E402
from repro.configs.common import dense_lm  # noqa: E402
from repro.data import SyntheticLM, device_batch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import steps as JST  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

LR = 5e-3
MODES = {"f32": dict(compute_dtype="float32", fp32_grads=True), "bf16": {}}
RUNS = {a: (((1, 1), "bf16"), ((2, 2), "f32"), ((2, 2), "bf16"),
            ((1, 4), "f32"), ((1, 4), "bf16")) for a in W.ARCHS}
RUNS["yi-9b"] += (((4, 1), "f32"),)
RUNS["deepseek-v2-lite-16b"] += (((4, 1), "f32"),)
RUNS["zamba2-1.2b"] += (((1, 1), "f32"),)
RUNS["kv16"] = ()
RUNS.update({a: ((shape, "f32"),) for a, shape in W.F32_ONLY.items()})
# tests/test_torch_ssm_split.py (PART "ssm"): SSM_TRAIN in f32 on one
# device and on each of its meshes, and the serve runs of W.SSM_DECODE
SSM_RUNS = {W.SSM_TRAIN: tuple((shape, "f32") for shape in
                               ((1, 1), (1, 2), (2, 2), (1, 4)))}
# the blocks' caches with a sequence (axis −2), padded to smax after
# prefill: attention's and MLA's; a recurrent state has none
SEQ_CACHES = ({"k", "v"}, {"c", "kpe"})


def ref_config(arch: str):
    """The reference's config of ``W.tp_config(arch)``."""
    if arch == "kv16":
        return dense_lm("kv16-tiny", **W.KV16)
    return JC.get_tiny(arch)


def port_named(params, arch: str) -> dict:
    """The reference's parameter tree as {port name: array}, in the port's
    ``named_parameters`` order."""
    named = lm_params_from_reference(jax.tree.map(np.asarray, params),
                                     W.tp_config(arch), device="cpu")
    return {n: named[n].numpy() for n, _ in TM.LM(
        W.tp_config(arch), device="meta").named_parameters()}


def port_vector(params, arch: str) -> np.ndarray:
    """The reference's parameter tree as one vector in the port's order."""
    return np.concatenate([v.reshape(-1)
                           for v in port_named(params, arch).values()])


def mesh_of(shape) -> Mesh:
    return Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                ("data", "model"))


def run(arch: str, shape, mode: str) -> dict:
    """3 train steps in ``mode`` on ``shape``: the losses, the parameters
    and (bf16) the first step's gradient."""
    mesh = mesh_of(shape)
    cfg = JC.get_tiny(arch)
    tc = JST.TrainConfig(opt=JA.OptConfig(lr=LR, warmup_steps=2,
                                          total_steps=60), **MODES[mode])
    state, sh = JST.init_state(jax.random.PRNGKey(0), cfg, tc, mesh)
    # placed as the step returns it, so the jitted step compiles once
    state = jax.device_put(state, sh)
    src = SyntheticLM(vocab=cfg.vocab, seq=32, global_batch=4)
    b0 = device_batch(mesh, src.host_batch(0))
    step = JST.make_train_step(cfg, tc, mesh, sh,
                               {k: v.sharding for k, v in b0.items()})
    out, losses = {}, []
    for i in range(3):
        state, m = step(state, device_batch(mesh, src.host_batch(i)))
        losses.append(float(m["loss"]))
        if i == 0 and mode == "bf16":
            # m₁ = (1 − β₁)·min(1, clip / (‖g‖ + 1e-9))·g
            scale = min(1.0, tc.opt.grad_clip
                        / (float(m["grad_norm"]) + 1e-9))
            out["first|m"] = port_vector(state.opt.m, arch) / np.float32(
                (1 - tc.opt.betas[0]) * scale)
    return {"losses": np.array(losses),
            "params": port_vector(state.params, arch), **out}


def serve(arch: str, mode: str, runs, shape=W.REF_SERVE_MESH) -> dict:
    """Each (prefill, smax) of ``runs`` on ``shape`` in ``mode``: prefill
    of ``prefill`` tokens, then decode to ``smax``: {(prefill, smax):
    logits (BATCH, smax − prefill + 1, vocab)}."""
    mesh = mesh_of(shape)
    cfg = ref_config(arch)
    tc = JST.TrainConfig(**({"compute_dtype": "float32"} if mode == "f32"
                            else {}))
    state, sh = JST.init_state(jax.random.PRNGKey(0), cfg, tc, mesh)
    params = jax.device_put(state.params, sh.params)
    decodes, out = {}, {}
    for pre, smax in runs:
        toks = W.serve_tokens(cfg.vocab, smax)
        specs = JM.cache_init_specs(cfg, W.BATCH, smax)
        tsh = JST.batch_shardings(mesh, cfg, "serve",
                                  {"tokens": toks[:, :1]})["tokens"]
        batch = {"tokens": toks[:, :pre]}
        prefill = JST.make_prefill_step(cfg, tc, mesh, sh.params,
                                        JST.batch_shardings(mesh, cfg,
                                                            "serve", batch))
        last, caches = prefill(params, device_batch(mesh, batch))
        caches = [{b: {n: jnp.pad(a, [(0, 0)] * (a.ndim - 2)
                                  + [(0, smax - pre), (0, 0)])
                       for n, a in c.items()} if set(c) in SEQ_CACHES
                   else c for b, c in seg.items()} for seg in caches]
        cshard = JSH.resolve_tree(mesh, specs, caches)
        caches = jax.device_put(caches, cshard)
        if smax not in decodes:
            decodes[smax] = JST.make_decode_step(cfg, tc, mesh, sh.params,
                                                 cshard, tsh)
        decode = decodes[smax]
        outs = [np.asarray(last[:, 0], np.float32)]
        for t in range(pre, smax):
            lg, caches = decode(params, jax.device_put(toks[:, t:t + 1],
                                                       tsh),
                                caches, jnp.asarray(t, jnp.int32))
            outs.append(np.asarray(lg[:, 0], np.float32))
        out[pre, smax] = np.stack(outs, 1)
    return out


def main(out: str, init: str, arch: str, part: str = "shard") -> None:
    state, _ = JST.init_state(jax.random.PRNGKey(0), ref_config(arch),
                              JST.TrainConfig())
    np.savez(init + ".tmp.npz", **port_named(state.params, arch))
    os.replace(init + ".tmp.npz", init)
    if part == "ssm":
        runs, serves = SSM_RUNS.get(arch, ()), W.SSM_DECODE.get(arch, ())
    else:
        runs, serves = RUNS[arch], W.REF_DECODE.get(arch, ())
    res = {}
    for shape, mode in runs:
        res.update({f"{shape}|{mode}|{k}": v
                    for k, v in run(arch, shape, mode).items()})
    for mode in ("f32", "bf16") if serves else ():
        res.update({f"{W.REF_SERVE_MESH}|serve|{mode}|{pre}|{smax}": v
                    for (pre, smax), v in serve(arch, mode, serves).items()})
    if serves and (part == "ssm" or arch in W.ROUTE_TIES):
        res.update({f"(1, 1)|serve|bf16|{pre}|{smax}": v for (pre, smax), v
                    in serve(arch, "bf16", serves, (1, 1)).items()})
    np.savez(out, **res)


if __name__ == "__main__":
    main(*sys.argv[1:])
