"""Production mesh builders, the reference's ``src/repro/launch/mesh.py``:
functions, not module-level constants, so importing this module touches
no process group.

A mesh is a ``DeviceMesh`` over the ranks of the running world (one
process per rank, ``torchrun --nproc-per-node N``); the ``*_shape``
helpers give the same shapes as a :class:`~repro_torch.pshard.MeshShape`
without a world, for layouts and byte counts.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..pshard import MeshShape

#: ``--mesh``'s axis names, the last ``len(shape)`` of these
AXES = ("pod", "data", "model")


def mesh_axes(shape: tuple[int, ...]) -> tuple[str, ...]:
    """The axis names of a ``--mesh`` shape, as the reference's
    ``launch/train.py`` names them."""
    if not 1 <= len(shape) <= len(AXES):
        raise ValueError(f"a mesh has 1 to {len(AXES)} axes, got {shape}")
    return AXES[-len(shape):]


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """(16, 16) ("data", "model") single pod; (2, 16, 16) ("pod", "data",
    "model") for the 2-pod, 512-rank run."""
    dims = (2, 16, 16) if multi_pod else (16, 16)
    return MeshShape(mesh_axes(dims), dims)


def mesh_shape_for(devices: int, model_parallel: int = 16) -> MeshShape:
    """Elastic helper: the best (data, model) shape for a surviving device
    count (model ≤ ``model_parallel``, halved until it divides)."""
    model = min(model_parallel, devices)
    while devices % model:
        model //= 2
    return MeshShape(("data", "model"), (devices // model, model))


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: MeshShape, device_type: str | None = None
              ) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over ranks [0, size) of the running
    world, row-major. Every rank of the world calls it (its groups are
    made collectively); a rank past the mesh gets a mesh without a
    coordinate (``get_coordinate()`` is None)."""
    if not dist.is_initialized():
        raise ValueError(f"a mesh of {shape.size()} ranks needs a process "
                         f"group: launch with torchrun --nproc-per-node="
                         f"{shape.size()}")
    world = dist.get_world_size()
    if shape.size() > world:
        raise ValueError(f"a {shape.dims} mesh needs {shape.size()} ranks "
                         f"and the world has {world}: launch with torchrun "
                         f"--nproc-per-node={shape.size()}")
    ranks = torch.arange(shape.size()).reshape(shape.dims)
    return DeviceMesh(device_type or _device_type(), ranks,
                      mesh_dim_names=shape.axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> DeviceMesh:
    """:func:`production_mesh_shape` as a ``DeviceMesh``; the world must
    have that many ranks (256 or 512)."""
    return make_mesh(production_mesh_shape(multi_pod=multi_pod), device_type)


def make_mesh_for(devices: int, model_parallel: int = 16,
                  device_type: str | None = None) -> DeviceMesh:
    """:func:`mesh_shape_for` as a ``DeviceMesh`` over ranks [0,
    ``devices``)."""
    return make_mesh(mesh_shape_for(devices, model_parallel), device_type)
