"""The cost model of a traced step: flops, device-memory bytes, collective
bytes and peak memory per rank, the reference's
``src/repro/launch/hlo_cost.py`` for the port.

There is no HLO here. :class:`CostMode` is a ``TorchDispatchMode`` that
sees every aten op a callable dispatches, on real tensors or on
``FakeTensor``\\ s (shapes and dtypes, no memory: the dry run,
:mod:`.dryrun`), and counts it with the reference's definitions:

  flops        2·M·N·K for matrix products (``mm``, ``bmm``, ``addmm``,
               ``baddbmm``), convolutions and fused attention, by
               ``torch.utils.flop_counter``'s formulas; 1 per output
               element for the elementwise arithmetic of
               :data:`ELEMENTWISE` (the reference's ``_ELEMENTWISE``
               in aten names);
  bytes        operands and results of every op but views and
               allocations: an upper bound on device-memory traffic;
  bytes_fused  operands and results of the ops that are device-memory
               boundaries (:data:`MEM_OPS`: products, gathers and index
               reads, scatters and ``index_put``, reductions and
               softmaxes, sort and top-k, collectives, the hand-written
               kernels); elementwise chains are taken as fused into
               them, as the reference takes XLA's fusion;
  coll_bytes   the ring model of :func:`.hlo.collective_stats` over every
               ``c10d`` collective the callable issues.

A hand-written kernel is charged by its own rules
(:mod:`repro_torch.kernels.cost`) when its wrapper receives a fake
tensor; a real launch is counted by ``kernels.ops.launch_counts``.

The reference parses loop bodies and multiplies them by their trip
counts, because XLA's own count does not. Eager dispatch runs every
Python loop's body once per trip (chunked attention, the sLSTM scan,
remat's recompute, FISTA's iterations), so :func:`step_cost` counts
loops by construction.

:class:`MemoryTracker` follows the storages a traced step creates and
frees, by category, for the peak the reference reads from
``memory_analysis()``.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..kernels import cost as kcost
from . import hlo

# the reference's _ELEMENTWISE (HLO opcodes) in aten names; an in-place
# variant ("add_") counts as its op
ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "abs", "neg",
    "exp", "log", "tanh", "rsqrt", "sqrt", "pow", "sign", "floor", "ceil",
    "cos", "sin", "sigmoid", "where", "eq", "ne", "lt", "le", "gt", "ge",
    "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor", "clamp",
    "clamp_min", "clamp_max", "atan2", "remainder", "fmod", "expm1",
    "log1p", "erf",
})

# the reference's _MEM_OPS (dot, convolution, gather, scatter,
# dynamic-slice/-update-slice, sort, reduce, reduce-window, custom-call,
# collectives) in aten names; the products and attention of the flop
# counter's registry, the c10d collectives and the kernels' charges too
MEM_OPS = frozenset({
    "embedding", "embedding_dense_backward", "index", "index_select",
    "gather", "take", "scatter", "scatter_add", "scatter_reduce",
    "index_put", "index_add", "index_copy", "slice_scatter",
    "select_scatter", "sum", "mean", "amax", "amin", "max", "min", "prod",
    "var", "std", "var_mean", "norm", "linalg_vector_norm", "logsumexp",
    "cumsum", "cumprod", "any", "all", "argmax", "argmin", "_softmax",
    "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
    "sort", "topk", "kthvalue",
})

# ops that move no data: allocations (views are told by ``func.is_view``)
_NO_BYTES = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                       "new_empty_strided"})


def _mv_flops(mat, vec, *args, out_val=None, **kwargs) -> int:
    return 2 * mat.numel()


def _addmv_flops(inp, mat, vec, *args, out_val=None, **kwargs) -> int:
    return 2 * mat.numel()


def _dot_flops(a, b, *args, out_val=None, **kwargs) -> int:
    return 2 * a.numel()


# torch.utils.flop_counter's products, with the matrix-vector products
# it leaves out (2·M·K, as the reference counts a dot of rank 1)
_FLOPS = {**flop_counter.flop_registry,
          torch.ops.aten.mv: _mv_flops, torch.ops.aten.addmv: _addmv_flops,
          torch.ops.aten.dot: _dot_flops, torch.ops.aten.vdot: _dot_flops}

# the c10d ops → the port's collective kinds (the reference's five)
_C10D = {"allreduce_": "all_reduce", "allgather_": "all_gather",
         "_allgather_base_": "all_gather", "reduce_scatter_": "reduce_scatter",
         "_reduce_scatter_base_": "reduce_scatter", "alltoall_": "all_to_all",
         "alltoall_base_": "all_to_all", "send": "permute"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0          # unfused upper bound
    bytes_fused: float = 0.0    # at the device-memory boundaries (roofline)
    coll_bytes: float = 0.0
    coll_counts: dict = dataclasses.field(default_factory=dict)
    coll_bytes_by_kind: dict = dataclasses.field(default_factory=dict)

    def __iadd__(self, o: "Cost"):
        self.flops += o.flops
        self.bytes += o.bytes
        self.bytes_fused += o.bytes_fused
        self.coll_bytes += o.coll_bytes
        for k, v in o.coll_counts.items():
            self.coll_counts[k] = self.coll_counts.get(k, 0) + v
        for k, v in o.coll_bytes_by_kind.items():
            self.coll_bytes_by_kind[k] = self.coll_bytes_by_kind.get(k, 0) + v
        return self

    def scaled(self, mult: float) -> "Cost":
        return Cost(self.flops * mult, self.bytes * mult,
                    self.bytes_fused * mult, self.coll_bytes * mult,
                    {k: v * mult for k, v in self.coll_counts.items()},
                    {k: v * mult for k, v in self.coll_bytes_by_kind.items()})


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _collective(name: str, args) -> hlo.CollectiveRecord:
    """The record of one c10d call: the bytes this rank sends in (its
    input tensors) and its group's size. ``allreduce_`` and ``send`` take
    (tensors, group, ...); the others (outputs, inputs, group, ...)."""
    first = name in ("allreduce_", "send")
    group = dist.ProcessGroup.unbox(args[1 if first else 2]).size()
    sent = _tensors(args[0] if first else args[1])
    return hlo.CollectiveRecord(_C10D[name], sum(map(_nbytes, sent)), group)


class CostMode(TorchDispatchMode):
    """Counts every aten op dispatched inside it into :attr:`cost` (module
    doc). Also kept: :attr:`dot_flops` (the products' share of the
    flops), :attr:`bytes_by_op` ({aten op: unfused bytes}),
    :attr:`records` (one
    :class:`~.hlo.CollectiveRecord` per collective call) and
    :attr:`kernels` ({kernel: {"launches", "flops", "bytes"}}, the fake
    launches charged)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.dot_flops = 0.0
        self.bytes_by_op: collections.Counter = collections.Counter()
        self.records: list[hlo.CollectiveRecord] = []
        self.kernels: dict[str, dict[str, float]] = {}

    def __enter__(self):
        kcost.RECORDERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kcost.RECORDERS.remove(self)
        return super().__exit__(*exc)

    def charge_kernel(self, op: str, kc: kcost.KernelCost) -> None:
        k = self.kernels.setdefault(op, {"launches": 0, "flops": 0.0,
                                         "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += kc.flops
        k["bytes"] += kc.bytes
        self.cost.flops += kc.flops
        self.cost.bytes += kc.bytes
        self.cost.bytes_fused += kc.bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        c = self.cost
        if func.namespace == "c10d":
            if name in _C10D:
                rec = _collective(name, args)
                self.records.append(rec)
                stats = hlo.collective_stats([rec])
                c += Cost(coll_bytes=stats.total_bytes,
                          coll_counts=stats.counts,
                          coll_bytes_by_kind=stats.bytes_by_kind)
                moved = sum(map(_nbytes, _tensors((args, out))))
                c.bytes += moved
                c.bytes_fused += moved
            return out
        if func.namespace != "aten":        # prim.device and other queries
            return out
        flops = 0.0
        if packet in _FLOPS:
            flops = float(_FLOPS[packet](*args, **kwargs, out_val=out))
            self.dot_flops += flops
        elif name.rstrip("_") in ELEMENTWISE:
            flops = float(sum(t.numel() for t in _tensors(out)))
        c.flops += flops
        if func.is_view or name in _NO_BYTES:
            return out
        moved = sum(map(_nbytes, _tensors((args, kwargs, out))))
        c.bytes += moved
        self.bytes_by_op[name] += moved
        if packet in _FLOPS or name in MEM_OPS:
            c.bytes_fused += moved
        return out


def step_cost(fn, *args, **kwargs) -> Cost:
    """The :class:`Cost` of one call of ``fn``: every loop it runs is
    counted as it runs."""
    with CostMode() as mode:
        fn(*args, **kwargs)
    return mode.cost


# ---------------------------------------------------------------------------
# Peak memory of a traced step
# ---------------------------------------------------------------------------

CATEGORIES = ("parameters", "optimizer", "inputs", "activations",
              "gradients")


class MemoryTracker(TorchDispatchMode):
    """Live bytes per category while a step runs, by storage: a storage
    is added when an op first returns it and taken off when it is freed
    (``weakref.finalize``), so views and in-place results add nothing.
    What exists before the step is :meth:`register`\\ ed: the rank's
    ``parameters`` (its f32 master shards), the ``optimizer``'s moments
    and the ``inputs`` (batch, caches). A storage the step creates is
    ``gradients`` while autograd's backward runs and ``activations``
    (activations and every other temporary) otherwise.

    :attr:`peak` is the most bytes live at once, :attr:`peak_by` the
    categories at that moment: the counterpart of XLA's
    ``memory_analysis()`` peak, without the allocator's rounding."""

    def __init__(self):
        super().__init__()
        self.live = dict.fromkeys(CATEGORIES, 0)
        self.current = 0
        self.peak = 0
        self.peak_by = dict(self.live)
        self._seen: dict[int, tuple[str, int]] = {}

    def register(self, tree, category: str) -> int:
        """Count the storages of a tree's tensors under ``category``;
        returns the bytes added."""
        return sum(self._add(t, category) for t in _tensors(tree))

    def storages(self, tree) -> set[int]:
        return {t.untyped_storage()._cdata for t in _tensors(tree)}

    def _add(self, t: torch.Tensor, category: str) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return 0
        n = st.nbytes()
        self._seen[key] = (category, n)
        self.live[category] += n
        self.current += n
        weakref.finalize(st, self._free, key)
        if self.current > self.peak:
            self.peak = self.current
            self.peak_by = dict(self.live)
        return n

    def _free(self, key: int) -> None:
        hit = self._seen.pop(key, None)
        if hit is not None:
            self.live[hit[0]] -= hit[1]
            self.current -= hit[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        category = ("gradients" if torch._C._current_graph_task_id() != -1
                    else "activations")
        for t in _tensors(out):
            self._add(t, category)
        return out


def memory_record(tracker: MemoryTracker, arguments: int, outputs,
                  argument_keys: set[int]) -> dict:
    """The reference's ``memory`` keys from a tracked step: ``argument_gb``
    the bytes registered before it, ``output_gb`` the storages of its
    outputs, ``alias_gb`` those of them that are arguments (a state
    updated in place), ``temp_gb`` the rest of the peak, so that
    ``peak_per_device_gb`` = argument + output + temp − alias is the
    tracked peak; ``peak_by_category_gb`` the categories at the peak."""
    sizes = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
             for t in _tensors(outputs)}
    out = sum(sizes.values())
    alias = sum(n for k, n in sizes.items() if k in argument_keys)
    temp = tracker.peak - arguments - (out - alias)
    return {"argument_gb": arguments / 1e9, "output_gb": out / 1e9,
            "temp_gb": temp / 1e9, "alias_gb": alias / 1e9,
            "peak_per_device_gb": tracker.peak / 1e9,
            "peak_by_category_gb": {k: v / 1e9
                                    for k, v in tracker.peak_by.items()}}


# ---------------------------------------------------------------------------
# The device of a dry run's fake tensors
# ---------------------------------------------------------------------------

def fake_device(device: str | None = None) -> torch.device:
    """The device a dry run's fake tensors claim. By default the card
    where this torch is built with CUDA, else the CPU; ``cuda`` is the
    card's first device (an index is needed where no card answers for
    it). A torch built without CUDA refuses to index fake CUDA tensors
    ("not linked with support for cuda devices"): there give ``cpu``."""
    if device is None:
        device = "cuda" if torch.backends.cuda.is_built() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", dev.index or 0)
    return dev


def fake_mode() -> FakeTensorMode:
    """A ``FakeTensorMode`` for a dry run: real tensors met inside (a
    host table copied to the device) become fake."""
    return FakeTensorMode(allow_non_fake_inputs=True)
