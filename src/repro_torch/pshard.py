"""Logical-axis → mesh-axis resolution (MaxText-style sharding rules), the
reference's ``src/repro/pshard.py`` over a torch ``DeviceMesh``, and the
collectives that move a sharded leaf between its ranks.

Models annotate parameters and caches with *logical* specs (:class:`P`
of "embed", "vocab", "heads", …). This module maps them onto the
physical mesh, dropping any axis whose dimension is not divisible by the
assigned mesh-axis product (kv = 4 heads cannot shard over 16 model
ranks: that dim falls back to replication and the divisible dims still
shard), as the reference does.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` with named
axes, or a :class:`MeshShape` (names and sizes, no process group) where
only shapes are asked for (:mod:`repro_torch.launch.mesh`, the per-rank
byte counts). The reference's ``NamedSharding`` of a leaf becomes a
:class:`Layout`: the physical spec, the global shape and the mesh, from
which the rank's local slice follows.

**One process per rank.** The reference's GSPMD partitions one program;
the port runs one process per rank with explicit collectives
(:mod:`repro_torch.train.steps`). A rank computes on its rows of the
batch, and its activations span the model ranks of its data group as
the reference's rules lay them out:

* within a **split region** (attention, MLA, Mamba2 and mLSTM heads,
  the dense FFN's hidden width, MoE experts, the vocabulary: a
  dimension :func:`resolve_spec` cuts over "model"), each model rank
  computes its part from its block of the leaves (or, for a leaf whose
  columns concatenate unlike parts, from its :class:`Pieces`). A
  module declares its region with a :class:`Split`. :func:`enter` opens a region (the
  identity forward; the gradient summed over "model" in backward) and
  :func:`leave` closes it (a sum over "model" forward; the identity
  backward), the reference's ``with_sharding_constraint`` pairs as GSPMD
  partitions them.
  :func:`model_shard` tells a layer its index and the axis's size;
  :func:`model_sum` sums a statistic every rank reads whole (a gated
  norm's sum of squares over a width cut over "model");
* between regions activations are replicated over "model";
* MoE routing runs over the whole batch
  (:func:`repro_torch.models.layers.moe_route`), which reads the rank's
  place in the batch from :func:`batch_shard`.

:func:`constrain` stays the identity: the layers split where their
leaves are split, which is where the reference's constraints put GSPMD's
cuts.

Every collective goes through :func:`gather`, :func:`all_reduce`,
:func:`reduce_scatter`, :func:`all_gather_rows` or
:func:`all_gather_dim` and is counted by kind
(:func:`collective_counts`, the dry run's kinds) and by purpose
(:func:`collective_tags`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import unset_fake_temporarily

# default logical → physical rules; first applicable wins per logical name
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),     # data parallel (across pods too)
    "embed": ("data",),           # fsdp-style weight shard
    "vocab": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "ffn": ("model",),
    "experts": ("model",),
    "lora": (),                   # replicated (small MLA bottleneck)
    "tensor": ("model",),
    "seq": (),                    # sequence sharding off by default
}


class P(tuple):
    """The reference's ``PartitionSpec``: a tuple of per-dim entries, each
    ``None``, a name, or a tuple of names; it compares equal to a
    ``PartitionSpec`` with the same entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes without devices or process groups:
    the reference's ``Mesh`` as far as :func:`resolve_spec` reads it."""
    axis_names: tuple[str, ...]
    dims: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    def size(self) -> int:
        return math.prod(self.dims)


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", None)
    if not names:
        raise ValueError("the mesh needs named axes, e.g. init_device_mesh("
                         "..., mesh_dim_names=('data', 'model'))")
    return tuple(names)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis: size} of a ``DeviceMesh``, a :class:`MeshShape` or the
    reference's ``Mesh``."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(axis_names(mesh), tuple(shape)))


def physical_axes(mesh, logical: str | None,
                  rules: dict | None = None) -> tuple[str, ...]:
    if logical is None:
        return ()
    rules = rules or DEFAULT_RULES
    axes = rules.get(logical, ())
    names = axis_names(mesh)
    return tuple(a for a in axes if a in names)


def resolve_spec(mesh, spec, shape: tuple[int, ...],
                 rules: dict | None = None) -> P:
    """Logical spec + concrete shape → physical spec (divisibility-checked)."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, logical in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        axes = physical_axes(mesh, logical, rules)
        size = math.prod(sizes[a] for a in axes)
        if axes and dim % size == 0:
            out.append(axes if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    return P(*out)


def _dim_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a leaf lives on a mesh: its physical spec (per dim ``None``,
    an axis or a tuple of axes, as :func:`resolve_spec` returns it) and
    its global shape. Each rank holds one block: along a dim cut over
    axes (a₁, a₂, …) the block's index is the rank's coordinates on them,
    row-major in that order, as ``NamedSharding`` cuts it."""
    spec: P
    shape: tuple[int, ...]
    mesh: object = dataclasses.field(compare=False, repr=False)

    def dim_axes(self, dim: int) -> tuple[str, ...]:
        return _dim_axes(self.spec[dim])

    @property
    def axes(self) -> tuple[str, ...]:
        """The axes the leaf is cut over, in the mesh's order."""
        used = {a for d in range(len(self.shape)) for a in self.dim_axes(d)}
        return tuple(a for a in axis_names(self.mesh) if a in used)

    def shards(self, dim: int) -> int:
        sizes = axis_sizes(self.mesh)
        return math.prod(sizes[a] for a in self.dim_axes(dim))

    @property
    def local_shape(self) -> tuple[int, ...]:
        return tuple(n // self.shards(d) for d, n in enumerate(self.shape))

    def index(self, coord: dict[str, int] | None = None) -> tuple[slice, ...]:
        """The slice of the global leaf held at ``coord`` ({axis: index};
        by default this rank's coordinate on a ``DeviceMesh``)."""
        if coord is None:
            coord = coordinate(self.mesh)
        sizes = axis_sizes(self.mesh)
        out = []
        for d, n in enumerate(self.shape):
            block = 0
            for a in self.dim_axes(d):
                block = block * sizes[a] + coord[a]
            width = n // self.shards(d)
            out.append(slice(block * width, (block + 1) * width))
        return tuple(out)

    def part(self, axes) -> "Layout":
        """The layout of this rank's block as far as ``axes`` cut it: a
        dim cut over axes among ``axes`` keeps its cut, every other dim
        is this rank's width, uncut. :func:`gather` of a block with it
        gathers over ``axes`` alone."""
        spec, shape = [], []
        for d, n in enumerate(self.shape):
            on = self.dim_axes(d)
            if on and all(a in axes for a in on):
                spec.append(self.spec[d])
                shape.append(n)
            elif any(a in axes for a in on):
                raise ValueError(f"dim {d} of {self} is cut over {on}, "
                                 f"partly in {axes}")
            else:
                spec.append(None)
                shape.append(n // self.shards(d))
        return Layout(P(*spec), tuple(shape), self.mesh)

    def only(self, axes) -> "Layout":
        """The same leaf cut over ``axes`` alone (a dim cut over other
        axes is whole)."""
        return Layout(P(*(e if any(a in axes for a in _dim_axes(e))
                          else None for e in self.spec)), self.shape,
                      self.mesh)

    def stacked(self, repeat: int) -> "Layout":
        """The layout of ``repeat`` such leaves stacked on a new, uncut
        axis 0 (the reference's stacked segment leaves)."""
        return Layout(P(None, *self.spec), (repeat, *self.shape), self.mesh)


def rank_table(mesh) -> np.ndarray:
    """A ``DeviceMesh``'s ranks as plain integers, in its shape. Read
    outside any fake mode: under a dry run's ``FakeTensorMode`` the
    mesh's rank tensor would be made fake and could not be read."""
    with unset_fake_temporarily():
        return np.asarray(mesh.mesh.tolist(), dtype=np.int64)


def coordinate(mesh) -> dict[str, int]:
    """This rank's {axis: index} on a ``DeviceMesh``."""
    where = mesh.get_coordinate()
    if where is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    return dict(zip(axis_names(mesh), where))


def resolve_tree(mesh, spec_tree, shape_tree, rules=None):
    """A tree of logical specs and a matching tree of shapes (tensors,
    meta tensors, ``torch.Size`` or tuples) → the tree of
    :class:`Layout`\\ s. Dicts and lists are walked; a :class:`P` (or any
    tuple of names) in ``spec_tree`` is a leaf."""
    if isinstance(spec_tree, Mapping):
        return {k: resolve_tree(mesh, v, shape_tree[k], rules)
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [resolve_tree(mesh, v, s, rules)
                for v, s in zip(spec_tree, shape_tree)]
    shape = tuple(getattr(shape_tree, "shape", shape_tree))
    return Layout(resolve_spec(mesh, spec_tree, shape, rules), shape, mesh)


def batch_axes(mesh) -> tuple[str, ...]:
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def batch_spec(mesh, ndim: int, dim0: int | None = None) -> P:
    """Batch sharding over (pod, data); degrades to the largest prefix whose
    size divides dim0 (long_500k has global_batch=1 — fully replicated)."""
    sizes = axis_sizes(mesh)
    axes = list(batch_axes(mesh))
    if dim0 is not None:
        while axes:
            if dim0 % math.prod(sizes[a] for a in axes) == 0:
                break
            axes.pop(0)          # drop "pod" first, then "data"
    if not axes:
        return P(*(None,) * ndim)
    return P(tuple(axes) if len(axes) > 1 else axes[0],
             *(None,) * (ndim - 1))


# ---------------------------------------------------------------------------
# Activation sharding
# ---------------------------------------------------------------------------

def set_activation_mesh(mesh) -> None:
    """The reference registers the mesh that :func:`constrain` resolves
    against; here it does nothing: the steps set the model axis's context
    (:func:`model_context`) themselves."""


def constrain(x, logical: tuple):
    """The reference's ``with_sharding_constraint`` by logical names: the
    identity. The reference adds the constraints to steer GSPMD's
    partitioner; the port's layers split where their leaves are split
    (:func:`enter`, :func:`leave`)."""
    return x


# ---------------------------------------------------------------------------
# The rank's place in the batch (MoE routing over the whole batch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchShard:
    """The batch's rows are cut over ``axes`` of ``mesh`` into ``count``
    equal blocks, and this rank holds block ``index``."""
    mesh: object
    axes: tuple[str, ...]
    count: int
    index: int


_BATCH: BatchShard | None = None


def batch_shard() -> BatchShard | None:
    """The batch shard of the step running on this rank, or None when the
    batch is whole on every rank."""
    return _BATCH


@contextlib.contextmanager
def batch_context(mesh, spec: P):
    """Within the block, :func:`batch_shard` tells that the batch's rows
    are cut as ``spec``'s dim 0 over ``mesh`` (a batch spec from
    :func:`batch_spec`). A whole batch sets nothing."""
    global _BATCH
    axes = _dim_axes(spec[0]) if len(spec) else ()
    prev = _BATCH
    if axes:
        sizes, coord = axis_sizes(mesh), coordinate(mesh)
        index = 0
        for a in axes:
            index = index * sizes[a] + coord[a]
        _BATCH = BatchShard(mesh, axes, math.prod(sizes[a] for a in axes),
                            index)
    else:
        _BATCH = None
    try:
        yield _BATCH
    finally:
        _BATCH = prev


# ---------------------------------------------------------------------------
# The rank's place on the "model" axis (split regions)
# ---------------------------------------------------------------------------

MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """The mesh's "model" axis has ``count`` ranks and this rank is
    ``index`` on it: a dimension cut over "model" holds block ``index``
    of ``count`` here."""
    mesh: object
    count: int
    index: int

    def block(self, n: int) -> tuple[int, int]:
        """(first, width) of this rank's block of a dimension of ``n``."""
        return self.index * (n // self.count), n // self.count


_MODEL: ModelShard | None = None


def model_shard() -> ModelShard | None:
    """The "model" axis of the step running on this rank, or None when
    it has one rank (or there is none): every leaf is whole along it."""
    return _MODEL


@contextlib.contextmanager
def model_context(mesh):
    """Within the block, :func:`model_shard` gives this rank's place on
    ``mesh``'s "model" axis (None where the axis is absent or of size
    1)."""
    global _MODEL
    prev = _MODEL
    sizes = axis_sizes(mesh)
    if sizes.get(MODEL_AXIS, 1) > 1:
        _MODEL = ModelShard(mesh, sizes[MODEL_AXIS],
                            coordinate(mesh)[MODEL_AXIS])
    else:
        _MODEL = None
    try:
        yield _MODEL
    finally:
        _MODEL = prev


def _summed(t: torch.Tensor, sh: ModelShard, tag: str,
            own: bool) -> torch.Tensor:
    """``t`` summed over "model" in f32, in ``t``'s dtype (the wire
    carries f32: gloo reduces no bfloat16, and the reference's partial
    products are f32). ``own``: ``t`` is the caller's to overwrite, and
    a dense f32 ``t`` is reduced in place rather than copied."""
    wire = t.to(torch.float32, copy=not own).contiguous()
    all_reduce(wire, sh.mesh, (MODEL_AXIS,), tag=tag)
    return wire.to(t.dtype)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sh, tag):
        ctx.sh, ctx.tag = sh, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # autograd may hand the same incoming gradient to other uses
        return _summed(g, ctx.sh, ctx.tag, own=False), None, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sh, tag):
        # x is a fresh partial (a product's output), read by nothing else
        out = _summed(x, sh, tag, own=True)
        if out is x:                     # summed in place
            ctx.mark_dirty(x)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def enter(x: torch.Tensor, sh: ModelShard,
          tag: str = "region") -> torch.Tensor:
    """Open a split region: ``x`` (replicated over "model") unchanged; in
    backward its gradient, each rank's part, is summed over "model"."""
    return _Enter.apply(x, sh, tag)


def leave(x: torch.Tensor, sh: ModelShard,
          tag: str = "region") -> torch.Tensor:
    """Close a split region: each rank's partial ``x`` summed over
    "model" (in f32, returned in ``x``'s dtype); in backward the
    gradient passes unchanged."""
    return _Leave.apply(x, sh, tag)


def model_sum(t: torch.Tensor, sh: ModelShard, tag: str) -> torch.Tensor:
    """Each rank's partial ``t`` summed over "model" (in f32, in ``t``'s
    dtype), for a statistic that every rank then reads whole: in
    backward each rank's part of its gradient is summed over "model"
    too (:func:`enter` of :func:`leave`)."""
    return enter(leave(t, sh, tag), sh, tag)


def model_max(t: torch.Tensor, sh: ModelShard, tag: str) -> torch.Tensor:
    """A new tensor: the elementwise MAX of ``t`` over "model" (no
    gradient)."""
    wire = t.detach().clone().contiguous()
    all_reduce(wire, sh.mesh, (MODEL_AXIS,), op="max", tag=tag)
    return wire


class Pieces(NamedTuple):
    """A leaf whose dim ``dim`` concatenates parts of ``widths`` (Mamba2's
    ``w_in``: [z | x | B | C | dt]), where each part flagged in ``cut``
    is laid out head by head and the others are read by every head. A
    rank of a split region reads block ``index`` of ``count`` of each
    cut part and the others whole: its pieces, which are not its
    contiguous block of the leaf."""
    dim: int
    widths: tuple[int, ...]
    cut: tuple[bool, ...]

    def spans(self, index: int, count: int) -> list[tuple[int, int]]:
        """(first, width) of each piece along ``dim``, in order."""
        out, at = [], 0
        for w, c in zip(self.widths, self.cut):
            out.append((at + index * (w // count), w // count) if c
                       else (at, w))
            at += w
        return out

    def take(self, t: torch.Tensor, index: int,
             count: int) -> torch.Tensor:
        """The pieces of a whole ``t`` (a new tensor)."""
        return torch.cat([t.narrow(self.dim, a, n)
                          for a, n in self.spans(index, count)], self.dim)

    def place(self, g: torch.Tensor, index: int,
              count: int) -> torch.Tensor:
        """The inverse of :meth:`take`: ``g``, shaped as the pieces, at
        their places in a zero tensor shaped as the whole."""
        shape = list(g.shape)
        shape[self.dim] = sum(self.widths)
        out = g.new_zeros(shape)
        at = 0
        for a, n in self.spans(index, count):
            out.narrow(self.dim, a, n).copy_(g.narrow(self.dim, at, n))
            at += n
        return out

    def join(self, t: torch.Tensor, sh: ModelShard,
             tag: str) -> torch.Tensor:
        """Every model rank's pieces ``t`` (no gradient) → the whole:
        each cut piece gathered over "model", the others as they are."""
        parts, at = [], 0
        for n, c in zip(self.widths, self.cut):
            w = n // sh.count if c else n
            part = t.narrow(self.dim, at, w)
            parts.append(all_gather_dim(part, sh, self.dim, tag) if c
                         else part)
            at += w
        return torch.cat(parts, self.dim)


class Split(NamedTuple):
    """A module's split region: it computes its part on each model rank
    where dim ``dim`` of its leaf ``mark`` is cut over "model" in blocks
    of a multiple of ``unit`` (a head's width), else whole, its leaves
    gathered whole. ``inside``: the leaves read inside the region (None:
    all), whose gradients are each model rank's part where they are
    replicated over "model"; ``pieces``: {leaf: :class:`Pieces`} of the
    leaves the rank reads as pieces (gathered over "model" where they
    are cut over it, their gradients summed over it)."""
    mark: str
    dim: int
    inside: tuple[str, ...] | None = None
    unit: int = 1
    pieces: dict | None = None

    def on(self, lay: "Layout") -> bool:
        """Whether the region splits, ``lay`` the mark's layout."""
        if MODEL_AXIS not in lay.dim_axes(self.dim):
            return False
        return (lay.shape[self.dim] // lay.shards(self.dim)) % self.unit == 0


# ---------------------------------------------------------------------------
# Collectives over mesh axes, counted
# ---------------------------------------------------------------------------

# {(kind, purpose): [calls, bytes]}
_COUNTS: dict[tuple[str, str], list[int]] = {}


def reset_collectives() -> None:
    _COUNTS.clear()


def _summed_by(pos: int) -> dict[str, tuple[int, int]]:
    out: dict[str, list[int]] = {}
    for key, (calls, nbytes) in _COUNTS.items():
        c = out.setdefault(key[pos], [0, 0])
        c[0] += calls
        c[1] += nbytes
    return {k: (v[0], v[1]) for k, v in sorted(out.items())}


def collective_counts() -> dict[str, tuple[int, int]]:
    """{kind: (calls, bytes)} since :func:`reset_collectives`: the bytes
    are this rank's contribution (the block an all-gather sends, the
    tensor an all-reduce or a reduce-scatter reduces). A MAX all-reduce
    counts as an all-reduce, as the dry run counts its ``c10d`` op."""
    return _summed_by(0)


def collective_tags() -> dict[str, tuple[int, int]]:
    """:func:`collective_counts` by purpose: ``gather`` (the leaves'
    gathers), ``grad`` (the gradients' reductions), ``norm`` (the clip's
    sums of squares), ``region`` (attention's and the dense FFN's split
    regions' sums over "model", forward and backward), ``mla``,
    ``experts`` and ``shared`` (the same sums of MLA's, the routed
    experts' and a MoE's shared experts' regions), ``mamba`` and
    ``mlstm`` (the Mamba2 and mLSTM regions' sums), ``norm_ss`` (their
    gated norms' sums of squares, forward and backward), ``state`` (the
    recurrent caches gathered over "model" to or from the compute's
    layout in prefill and decode), ``embed`` (the
    vocab-parallel lookup), ``vocab_max`` and ``vocab_sum`` (the
    vocab-parallel loss), ``logits`` (the last logits gathered over
    "model"), ``decode_q``, ``decode_kv``, ``decode_max`` and
    ``decode_sum`` (decode on a sequence-cut cache), ``cache`` (caches
    moved between layouts), ``loss`` and ``route``."""
    return _summed_by(1)


def _count(kind: str, t: torch.Tensor, tag: str | None = None) -> None:
    c = _COUNTS.setdefault((kind, tag or kind), [0, 0])
    c[0] += 1
    c[1] += t.numel() * t.element_size()


# (weakref to the mesh, {axes: (group, ranks in axis order)}), by id(mesh)
_GROUPS: dict[int, tuple] = {}
# {ranks: group} made by new_group under the default group in [0]
_RANK_GROUPS: list = [None, {}]


def _ranks_group(ranks: list[int]):
    """One process group per rank set and default group: a group made with
    ``use_local_synchronization`` is named after its ranks, so a second
    one over the same ranks would share the first one's store keys."""
    world = dist.group.WORLD
    if _RANK_GROUPS[0] is not world:
        _RANK_GROUPS[:] = [world, {}]
    key = tuple(ranks)
    if key not in _RANK_GROUPS[1]:
        _RANK_GROUPS[1][key] = dist.new_group(
            ranks=list(ranks), use_local_synchronization=True)
    return _RANK_GROUPS[1][key]


def _group(mesh, axes: tuple[str, ...]):
    """(process group, its size, this rank's index, the group ranks of the
    sub-mesh's members in row-major order over ``axes``) for the sub-mesh
    over ``axes`` through this rank. A single axis is the mesh's own
    group; several are made once per mesh and axes with ``new_group``
    by the sub-mesh's members alone (``use_local_synchronization``: a
    rank outside the mesh, as after an elastic restart on fewer ranks,
    takes no part). An axis of size 1 keeps its group, so its
    collectives run."""
    hit = _GROUPS.get(id(mesh))
    if hit is None or hit[0]() is not mesh:
        hit = (weakref.ref(mesh), {})
        _GROUPS[id(mesh)] = hit
    cache = hit[1]
    if axes not in cache:
        names = axis_names(mesh)
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        table = rank_table(mesh)
        size = math.prod(table.shape[d] for d in dims)
        rows = table.transpose(*rest, *dims).reshape(-1, size).tolist()
        me = dist.get_rank()
        mine = None
        for ranks in rows:
            if me not in ranks:
                continue
            group = (mesh.get_group(axes[0]) if len(axes) == 1
                     else _ranks_group(ranks))
            order = tuple(dist.get_group_rank(group, r) for r in ranks)
            mine = (group, size, ranks.index(me), order)
        if mine is None:
            raise ValueError(f"rank {me} is not in the mesh {mesh}")
        cache[axes] = mine
    return cache[axes]


def _all_gather(local: torch.Tensor, axes, mesh,
                tag: str | None = None) -> torch.Tensor:
    """(size, *local.shape): every member's block, in row-major order over
    ``axes``. bfloat16 travels as its bytes (gloo gathers no bfloat16)."""
    group, size, _, order = _group(mesh, tuple(axes))
    local = local.contiguous()
    wire = local.view(torch.uint8) if local.dtype == torch.bfloat16 \
        else local
    _count("all_gather", wire, tag)
    parts = [torch.empty_like(wire) for _ in range(size)]
    dist.all_gather(parts, wire, group=group)
    out = torch.stack([parts[r] for r in order])
    return out.view(local.dtype) if wire is not local else out


def gather(local: torch.Tensor, layout: Layout,
           tag: str | None = None) -> torch.Tensor:
    """The global leaf from every rank's block: one all-gather over the
    axes the leaf is cut over (none for a replicated leaf). A
    :meth:`Layout.part` gathers over some of them."""
    axes = layout.axes
    if not axes:
        return local
    sizes = axis_sizes(layout.mesh)
    parts = _all_gather(local, axes, layout.mesh, tag)
    # (s_a for a in axes, *local) → per dim: its axes in spec order, then
    # its local extent
    parts = parts.reshape(*(sizes[a] for a in axes), *local.shape)
    perm = []
    for d in range(local.dim()):
        perm += [axes.index(a) for a in layout.dim_axes(d)]
        perm.append(len(axes) + d)
    return parts.permute(*perm).reshape(layout.shape)


def cut(full: torch.Tensor, layout: Layout) -> torch.Tensor:
    """This rank's block of a global leaf (a copy; no communication)."""
    return full[layout.index()].clone()


_OPS = {"sum": "SUM", "max": "MAX"}


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum",
               tag: str | None = None) -> torch.Tensor:
    """SUM (or MAX) all-reduce of ``t`` in place over the sub-mesh of
    ``axes`` (none: the identity)."""
    if not axes:
        return t
    _count("all_reduce", t, tag)
    dense = t.contiguous()               # the wire wants dense memory
    dist.all_reduce(dense, op=getattr(dist.ReduceOp, _OPS[op]),
                    group=_group(mesh, tuple(axes))[0])
    return t if dense is t else t.copy_(dense)


def reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int,
                   tag: str | None = None) -> torch.Tensor:
    """A new tensor: ``t`` summed over the members of ``axis``, each
    member keeping its block along ``dim`` (block i at index i on the
    axis, as :meth:`Layout.index` cuts it)."""
    group, size, _, order = _group(mesh, (axis,))
    x = t.movedim(dim, 0)
    n = x.shape[0]
    blocks = x.reshape(size, n // size, *x.shape[1:])
    # the group's rank order[j] receives block j
    by_rank = [0] * size
    for j, q in enumerate(order):
        by_rank[q] = j
    wire = blocks[by_rank].reshape(x.shape).contiguous()
    out = torch.empty((n // size, *x.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _count("reduce_scatter", wire, tag)
    dist.reduce_scatter_tensor(out, wire, op=dist.ReduceOp.SUM,
                               group=group)
    return out.movedim(0, dim).contiguous()


def barrier(mesh) -> None:
    """Wait for every rank of the mesh (not of the world: ranks outside
    it may have left)."""
    dist.barrier(group=_group(mesh, axis_names(mesh))[0])


def all_gather_rows(local: torch.Tensor, mesh, axes,
                    tag: str | None = None) -> torch.Tensor:
    """Every member's ``local`` concatenated along dim 0 in row-major order
    over ``axes`` (the batch's row order)."""
    if not axes:
        return local
    parts = _all_gather(local, axes, mesh, tag)
    return parts.reshape(-1, *local.shape[1:])


def all_gather_dim(local: torch.Tensor, sh: ModelShard, dim: int,
                   tag: str | None = None) -> torch.Tensor:
    """Every model rank's ``local`` concatenated along ``dim`` in their
    order on "model" (no gradient)."""
    parts = _all_gather(local.detach(), (MODEL_AXIS,), sh.mesh, tag)
    return torch.cat(parts.unbind(0), dim=dim)


def sum_shards(values: list, layouts: list) -> list:
    """Per leaf, a scalar of its shard (a sum of squares) summed over the
    axes that cut the leaf, so that it is the whole leaf's: one
    all-reduce of a vector per distinct set of axes. A leaf replicated
    over an axis is counted once; on one rank the values are unchanged
    (adding zeros), so a sum over them in leaf order is the one-device
    sum's bits."""
    vec = torch.stack(values)
    groups: dict[tuple, list[int]] = {}
    for i, lay in enumerate(layouts):
        if lay.axes:
            groups.setdefault(lay.axes, []).append(i)
    for axes, idx in groups.items():
        pick = torch.zeros_like(vec, dtype=torch.bool)
        pick[idx] = True
        part = torch.where(pick, vec, 0.0)
        all_reduce(part, layouts[idx[0]].mesh, axes, tag="norm")
        vec = torch.where(pick, part, vec)
    return list(vec.unbind(0))
