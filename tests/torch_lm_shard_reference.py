"""The reference's own sharded train step, for tests/test_torch_lm_shard.py.

    python tests/torch_lm_shard_reference.py OUT.npz INIT.npz ARCH

runs in a process of its own, which sets ``XLA_FLAGS=
--xla_force_host_platform_device_count=4`` before importing JAX, the
reference's ``init_state(PRNGKey(0), ..., mesh)`` and
``make_train_step`` for 3 steps (lr 5e-3, SyntheticLM batches of 4 × 32)
on auto-typed meshes ``Mesh(devices.reshape(shape), ("data",
"model"))`` (``jax.make_mesh`` makes explicit axes, on which the
reference's ``jnp.take`` raises): (1, 1) in bf16, (2, 2) in bf16 and in
f32 with f32 gradients, and (4, 1) in f32 for the dense and MoE models
(each run compiles for 5–10 s, so the set is kept to what the test
reads). It first writes INIT.npz, the initial parameters under the
port's names (where every port arm of the test starts), then OUT.npz:
per run, the losses and the parameters after the run as one vector in
the port's parameter order (``"<shape>|<mode>|losses"``,
``"...|params"``).
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.data import SyntheticLM, device_batch  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import steps as JST  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

LR = 5e-3
MODES = {"f32": dict(compute_dtype="float32", fp32_grads=True), "bf16": {}}
RUNS = (((1, 1), "bf16"), ((2, 2), "f32"), ((2, 2), "bf16"))
MORE = {"yi-9b": (((4, 1), "f32"),),
        "deepseek-v2-lite-16b": (((4, 1), "f32"),)}


def port_named(params, arch: str) -> dict:
    """The reference's parameter tree as {port name: array}, in the port's
    ``named_parameters`` order."""
    named = lm_params_from_reference(jax.tree.map(np.asarray, params),
                                     TC.get_tiny(arch), device="cpu")
    return {n: named[n].numpy() for n, _ in TM.LM(
        TC.get_tiny(arch), device="meta").named_parameters()}


def port_vector(params, arch: str) -> np.ndarray:
    """The reference's parameter tree as one vector in the port's order."""
    return np.concatenate([v.reshape(-1)
                           for v in port_named(params, arch).values()])


def run(arch: str, shape, mode: str) -> dict:
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                ("data", "model"))
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
    losses = []
    for i in range(3):
        state, m = step(state, device_batch(mesh, src.host_batch(i)))
        losses.append(float(m["loss"]))
    return {"losses": np.array(losses),
            "params": port_vector(state.params, arch)}


def main(out: str, init: str, arch: str) -> None:
    state, _ = JST.init_state(jax.random.PRNGKey(0), JC.get_tiny(arch),
                              JST.TrainConfig())
    np.savez(init + ".tmp.npz", **port_named(state.params, arch))
    os.replace(init + ".tmp.npz", init)
    res = {}
    for shape, mode in RUNS + MORE.get(arch, ()):
        res.update({f"{shape}|{mode}|{k}": v
                    for k, v in run(arch, shape, mode).items()})
    np.savez(out, **res)


if __name__ == "__main__":
    main(*sys.argv[1:])
