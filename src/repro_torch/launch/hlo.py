"""Collective traffic and the three-term roofline of a traced step, the
reference's ``src/repro/launch/hlo.py`` for the port.

PyTorch has no HLO. The port's dry run (:mod:`.dryrun`) counts the aten
ops a step dispatches on fake tensors (:mod:`.hlo_cost`), and every
collective it issues is one call of a ``c10d`` op with its tensors and
its group. :func:`collective_stats` sizes those calls with the
reference's ring model, per participating rank:

  all-reduce         2·|in|
  all-gather         |out| − |in| = (k − 1)·b for a block of b bytes
                     over k ranks
  reduce-scatter     |in| − |out|
  all-to-all         |in|
  collective-permute |in|

A record holds what the rank contributes, as
:func:`repro_torch.pshard.collective_counts` counts it (the block an
all-gather sends, the tensor an all-reduce reduces), and the group's
size, so the conversion is exact.

:class:`Roofline` keeps the reference's three terms with the H100 SXM's
data-sheet rates (dense, 700 W) in place of the TPU's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

from ..kernels.cost import H100_HBM_BYTES_PER_S

# NVIDIA's H100 SXM data sheet (dense rates, 700 W)
H100_BF16_FLOPS_PER_S = 989e12     # bf16 tensor cores, dense
H100_NVLINK_BYTES_PER_S = 450e9    # one direction (NVLink 4: 900 GB/s both)

# the port's collective kinds → the reference's names
KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "permute": "collective-permute"}


class CollectiveRecord(NamedTuple):
    """One collective call: its kind (a key of :data:`KINDS`), the bytes
    this rank contributes and the size of its group."""
    kind: str
    nbytes: int
    group: int


def ring_bytes(rec: CollectiveRecord) -> int:
    """The bytes one call moves per participating rank (module doc)."""
    if rec.kind == "all_reduce":
        return 2 * rec.nbytes
    if rec.kind == "all_gather":
        return (rec.group - 1) * rec.nbytes
    if rec.kind == "reduce_scatter":
        return rec.nbytes - rec.nbytes // rec.group
    return rec.nbytes


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_by_kind: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def collective_stats(records) -> CollectiveStats:
    """Calls and ring-model bytes per kind (the reference's names) of an
    iterable of :class:`CollectiveRecord`\\ s."""
    counts: dict[str, int] = {}
    bts: dict[str, int] = {}
    for rec in records:
        kind = KINDS[rec.kind]
        counts[kind] = counts.get(kind, 0) + 1
        bts[kind] = bts.get(kind, 0) + ring_bytes(rec)
    return CollectiveStats(counts=counts, bytes_by_kind=bts)


def contributions(records) -> dict[str, tuple[int, int]]:
    """{kind: (calls, bytes contributed)} in the port's kinds: the form
    of :func:`repro_torch.pshard.collective_counts`."""
    out: dict[str, list[int]] = {}
    for rec in records:
        c = out.setdefault(rec.kind, [0, 0])
        c[0] += 1
        c[1] += rec.nbytes
    return {k: (v[0], v[1]) for k, v in sorted(out.items())}


@dataclasses.dataclass
class Roofline:
    """Three-term roofline of one rank's step. ``flops``, ``hbm_bytes``
    and ``coll_bytes`` are per rank (the dry run traces rank 0 of its
    world), so ``t_compute = flops / peak`` is the global flops over
    (chips × peak). The compute term takes the bf16 tensor-core rate,
    the collective term one NVLink direction."""

    flops: float                  # per-rank flops
    hbm_bytes: float              # per-rank device-memory bytes
    coll_bytes: float             # per-rank collective bytes (ring model)
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / H100_BF16_FLOPS_PER_S

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / H100_HBM_BYTES_PER_S

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / H100_NVLINK_BYTES_PER_S

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_total(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self):
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
        }


def roofline_from_cost(cost, chips: int) -> Roofline:
    """The roofline of a :class:`~repro_torch.launch.hlo_cost.Cost`:
    its flops, its fused device-memory bytes and its collective bytes."""
    return Roofline(flops=cost.flops, hbm_bytes=cost.bytes_fused,
                    coll_bytes=cost.coll_bytes, chips=chips)
