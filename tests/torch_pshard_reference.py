"""The reference's sharding on forced host devices, for
tests/test_torch_pshard.py.

    python tests/torch_pshard_reference.py OUT.npz

runs in a process of its own, which sets ``XLA_FLAGS=
--xla_force_host_platform_device_count=512`` before importing JAX, and
writes:

* for every tiny config, every parameter leaf of the reference's
  ``init_params`` placed (as zeros of its shape and dtype) under
  ``resolve_tree``'s ``NamedSharding`` on an auto-typed (2, 2) ("data",
  "model") mesh: each addressable shard's mesh coordinate and index
  (``"<arch>|<leaf path>"``: rows of (data, model, start₀, stop₀, …));
* ``make_mesh_for(d)``'s shape for d = 1 … 512 (``"mesh_for"``) and
  ``make_production_mesh``'s axis names and sizes (``"production"``,
  ``"production_multi_pod"``).
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.launch import mesh as JMESH  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import sharding as SH  # noqa: E402


def _path(kp) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in kp)


def shards(arch: str, mesh) -> dict:
    cfg = JC.get_tiny(arch)
    shapes = jax.eval_shape(lambda k: JM.init_params(k, cfg)[0],
                            jax.random.PRNGKey(0))
    layouts = SH.resolve_tree(mesh, JM.param_specs(cfg), shapes)
    where = {d: idx for idx, d in np.ndenumerate(mesh.devices)}
    out = {}
    for (kp, sds), sharding in zip(
            jax.tree_util.tree_flatten_with_path(shapes)[0],
            jax.tree.leaves(layouts)):
        x = jax.device_put(jnp.zeros(sds.shape, sds.dtype), sharding)
        rows = []
        for s in x.addressable_shards:
            row = list(where[s.device])
            for sl, n in zip(s.index, sds.shape):
                row += [sl.start or 0, n if sl.stop is None else sl.stop]
            rows.append(row)
        out[f"{arch}|{_path(kp)}"] = np.array(sorted(rows))
    return out


def main(out: str) -> None:
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    res = {}
    for arch in JC.ARCHS:
        res.update(shards(arch, mesh))
    res["mesh_for"] = np.array([list(JMESH.make_mesh_for(d).devices.shape)
                                for d in range(1, 513)])
    for tag, multi in (("production", False), ("production_multi_pod", True)):
        m = JMESH.make_production_mesh(multi_pod=multi)
        res[tag] = np.array([f"{a}={n}" for a, n in m.shape.items()])
    np.savez(out, **res)


if __name__ == "__main__":
    main(*sys.argv[1:])
