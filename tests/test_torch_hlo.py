"""The port's cost model (``repro_torch.launch.hlo``, ``.hlo_cost``) held
against the reference's loop-aware HLO model (``repro.launch.hlo_cost``)
on the same programs, the counterparts of tests/test_hlo.py; and the
hand-written kernels' fake launches held to their cost rules
(``repro_torch.kernels.cost``).

Tolerances: 2 % against the reference's count and the hand count, as
tests/test_hlo.py holds the reference to XLA's own count (the port adds
the elementwise ``tanh`` exactly as the reference does, 1 per output
element; the rest is the reference's loop bookkeeping)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch import hlo as JH
from repro.launch.hlo_cost import loop_aware_cost
from repro_torch.kernels import cost as KC
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, hlo, hlo_cost
from torch_fake_cuda import cuda_guard

N, P = 784, 50000          # the paper's MNIST-like main path


def _reference_flops(f, *shapes) -> float:
    co = jax.jit(f).lower(*[jax.ShapeDtypeStruct(s, jnp.float32)
                            for s in shapes]).compile()
    return loop_aware_cost(co.as_text()).flops


def _near(a, b, rel):
    return abs(a - b) <= rel * abs(b)


def test_python_loop_matches_the_reference_scan():
    """10 × tanh(x @ w[i]) at 128 × 256 × 256: the port's Python loop
    against the reference's count of its lax.scan twin and the hand
    count of the dots."""
    def scan(ws, x):
        return jax.lax.scan(lambda x, w: (jnp.tanh(x @ w), None), x, ws)[0]

    def loop(ws, x):
        for i in range(10):
            x = torch.tanh(x @ ws[i])
        return x

    rng = np.random.default_rng(0)
    ws = torch.from_numpy(rng.standard_normal((10, 256, 256), np.float32))
    x = torch.from_numpy(rng.standard_normal((128, 256), np.float32))
    with hlo_cost.CostMode() as mode:
        loop(ws, x)
    expect = 10 * 2 * 128 * 256 * 256
    assert mode.dot_flops == expect
    assert mode.cost.flops == expect + 10 * 128 * 256     # + the tanh
    ref = _reference_flops(scan, (10, 256, 256), (128, 256))
    assert _near(mode.cost.flops, ref, 0.02), (mode.cost.flops, ref)
    assert _near(mode.cost.flops, expect, 0.02)


def test_nested_loops_count_every_trip():
    """4 × 5 nested loops of tanh(c @ c) at 64³ against the reference's
    nested scans and 4·5·2·64³."""
    def scan(x):
        def outer(c, _):
            c, _ = jax.lax.scan(lambda c2, _: (jnp.tanh(c2 @ c2), None), c,
                                None, length=5)
            return c, None
        return jax.lax.scan(outer, x, None, length=4)[0]

    def loop(c):
        for _ in range(4):
            for _ in range(5):
                c = torch.tanh(c @ c)
        return c

    c = torch.eye(64)
    cost = hlo_cost.step_cost(loop, c)
    expect = 4 * 5 * 2 * 64 ** 3
    ref = _reference_flops(scan, (64, 64))
    assert _near(cost.flops, ref, 0.02), (cost.flops, ref)
    assert _near(cost.flops, expect, 0.02)


def test_a_loop_costs_its_trips():
    """Eager dispatch runs a loop's body once per trip, so a loop of 10
    costs ten of its body exactly: the undercount the reference's model
    exists to undo (XLA's count of a scan) cannot happen here."""
    w = torch.randn(10, 32, 32)
    one = hlo_cost.step_cost(lambda x: torch.tanh(x @ w[0]), torch.ones(8, 32))
    ten = hlo_cost.step_cost(
        lambda x: [x := torch.tanh(x @ w[i]) for i in range(10)],
        torch.ones(8, 32))
    assert ten.flops == 10 * one.flops
    assert ten.bytes_fused == 10 * one.bytes_fused


def test_one_product_is_counted_exactly():
    """tanh(x @ xᵀ) at 64 × 64: 2·64³ for the product, 64² for the tanh;
    bytes_fused is the product's operands and result, 3 · 64² · 4."""
    x = torch.ones(64, 64)
    with hlo_cost.CostMode() as mode:
        torch.tanh(x @ x.T)
    assert mode.dot_flops == 2 * 64 ** 3
    assert mode.cost.flops == 2 * 64 ** 3 + 64 ** 2
    assert mode.cost.bytes_fused == 3 * 64 * 64 * 4
    assert mode.cost.bytes == 5 * 64 * 64 * 4      # + tanh's in and out


STATIC_HLO = """
HloModule test

ENTRY %main (x: f32[128,64]) -> f32[128,64] {
  %x = f32[128,64]{1,0} parameter(0)
  %ar = f32[128,64]{1,0} all-reduce(%x), replica_groups={}, to_apply=%add
  %ag = f32[128,256]{1,0} all-gather(%ar), dimensions={1}
  ROOT %out = f32[128,64]{1,0} reduce-scatter(%ag), dimensions={1}
}
"""


def test_ring_model_matches_the_reference_on_its_static_collectives():
    """The reference's three static collectives (f32 128 × 64, a group of
    4), issued through a fake world of 4 and counted from their c10d
    calls: the reference's bytes for its HLO text, kind for kind."""
    in_b = 128 * 64 * 4
    x = torch.ones(128, 64)
    with dryrun.fake_world(4), hlo_cost.CostMode() as mode:
        dist.all_reduce(x)
        parts = [torch.empty_like(x) for _ in range(4)]
        dist.all_gather(parts, x)
        out = torch.empty(128, 64)
        dist.reduce_scatter(out, [torch.ones(128, 64) for _ in range(4)])
    assert [r.group for r in mode.records] == [4, 4, 4]
    st = hlo.collective_stats(mode.records)
    ref = JH.collective_stats(STATIC_HLO)
    assert st.bytes_by_kind == ref.bytes_by_kind
    assert st.counts == ref.counts == {"all-reduce": 1, "all-gather": 1,
                                       "reduce-scatter": 1}
    assert st.bytes_by_kind["all-reduce"] == 2 * in_b
    assert st.bytes_by_kind["all-gather"] == 128 * 256 * 4 - in_b
    assert mode.cost.coll_bytes == st.total_bytes
    assert hlo.contributions(mode.records) == {
        "all_gather": (1, in_b), "all_reduce": (1, in_b),
        "reduce_scatter": (1, 4 * in_b)}


def test_roofline_terms_at_the_h100_rates():
    r = hlo.Roofline(flops=989e12, hbm_bytes=3.35e12, coll_bytes=450e9,
                     chips=256)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 1.0) < 1e-9
    assert abs(r.t_collective - 1.0) < 1e-9
    assert r.dominant in ("compute", "memory", "collective")
    assert r.t_total == max(r.t_compute, r.t_memory, r.t_collective)
    c = hlo_cost.Cost(flops=2.0, bytes=9.0, bytes_fused=3.0, coll_bytes=4.0)
    assert hlo.roofline_from_cost(c, 8).as_dict()["hbm_bytes"] == 3.0


# the bound columns PERF.md §6 prints (ms, what bounds it), from
# chip_smoke.py's phase 3 shapes
BOUNDS = [
    (lambda: KC.bound("screen_matvec", N, P, 1), "0.0469", "bytes"),
    (lambda: KC.bound("edpp_screen_scores", N, P, 1), "0.0469", "bytes"),
    (lambda: KC.bound("screen_matvec", 3072, 99288, 1), "0.3643", "bytes"),
    (lambda: KC.bound("screen_matvec", N, P, 8), "0.0473", "bytes"),
    (lambda: KC.bound("screen_matvec", N, P, 16), "0.0478", "bytes"),
    (lambda: KC.bound("screen_matvec", N, P, 1, 2), "0.0235", "bytes"),
    (lambda: KC.bound("fista_step", N, 32, 1), "0.00003", "bytes"),
    (lambda: KC.bound("fista_step", N, 128, 8), "0.00013", "bytes"),
    (lambda: KC.group_bound(250, 200000, 10), "0.0597", "bytes"),
    (lambda: KC.group_bound(2048, 11008, 1), "0.0269", "bytes"),
    (lambda: KC.prox_bound(P, 1, 4), "0.000478", "bytes"),
    (lambda: KC.prox_bound(P, 8, 4), "0.00382", "bytes"),
    (lambda: KC.prox_bound(P, 1), "0.000299", "bytes"),
    (lambda: KC.cd_bound(32, 1, 10, False), "0.0000013", "bytes"),
    (lambda: KC.cd_bound(128, 8, 10, True), "0.000043", "operations"),
]


@pytest.mark.parametrize("case", range(len(BOUNDS)))
def test_kernel_bounds_keep_their_printed_values(case):
    fn, ms, by = BOUNDS[case]
    got, got_by = fn()
    assert got_by == by
    digits = len(ms.split(".")[1])
    assert f"{got:.{digits}f}" == ms, (got, ms)


def _fake(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="cuda")


@pytest.fixture(scope="module")
def fake_cuda():
    """Fake CUDA tensors indexable on a torch built without CUDA."""
    with cuda_guard():
        yield


KERNEL_CASES = {
    "screen_matvec": (lambda: ops.BACKENDS["cuda"].matvec(
        _fake(N, P), _fake(N)), [KC.column_pass("screen_matvec", N, P, 1)]),
    "screen_matvec_b12": (lambda: ops.BACKENDS["cuda"].matvec(
        _fake(N, P), _fake(12, N)),
        [KC.column_pass("screen_matvec", N, P, 8),
         KC.column_pass("screen_matvec", N, P, 4)]),
    "screen_matvec_bf16": (lambda: ops.BACKENDS["cuda"].matvec(
        _fake(N, P, dtype=torch.bfloat16), _fake(N)),
        [KC.column_pass("screen_matvec", N, P, 1, 2)]),
    "edpp_screen_scores": (lambda: ops.BACKENDS["cuda"].fused_scores(
        _fake(N, P), _fake(N), 0.5),
        [KC.column_pass("edpp_screen_scores", N, P, 1)]),
    "fista_step": (lambda: ops.BACKENDS["cuda"].fista_step(
        _fake(N, P), _fake(N), _fake(P), _fake(P), 0.1, 0.2, 0.3),
        [KC.column_pass("fista_step", N, P, 1)]),
    "group_screen_scores": (lambda: ops.BACKENDS["cuda"].group_scores(
        _fake(N, P), _fake(N), 10), [KC.group_pass(N, P, 10)]),
    "cd_gram_sweep": (lambda: ops.BACKENDS["cuda"].cd_gram_sweep(
        _fake(32, 32), _fake(32), _fake(32), 0.1, 10),
        [KC.cd_sweep(32, 1, 10, False)]),
    "prox_step": (lambda: ops.BACKENDS["cuda"].prox_step(
        _fake(P), _fake(4, P), _fake(P), params=_fake(3, 1)),
        [KC.prox(P, 1, 4)]),
}


@pytest.mark.usefixtures("fake_cuda")
@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_fake_launch_charges_the_cost_rules(name):
    """A CUDA fake tensor reaching a kernel's wrapper launches nothing and
    charges one KernelCost per launch it would make, from the rules the
    smoke's bound columns read; the outputs have the op's shapes."""
    fn, want = KERNEL_CASES[name]
    op = {"screen_matvec_b12": "screen_matvec"}.get(name, name)
    ops.reset_counts()
    with hlo_cost.fake_mode(), hlo_cost.CostMode() as mode:
        out = fn()
    assert ops.launch_counts() == dict.fromkeys(ops.OPS, 0)
    k = mode.kernels[op]
    assert k["launches"] == len(want)
    assert k["flops"] == sum(c.flops for c in want)
    assert k["bytes"] == sum(c.bytes for c in want)
    assert all(t.device.type == "cuda" and t.dtype == torch.float32
               for t in (out if isinstance(out, tuple) else (out,)))


def test_a_real_tensor_never_reaches_the_fake_charge():
    """A real CPU tensor takes the plain version and charges nothing; a
    real CUDA tensor would launch (the card's tests)."""
    X, c = torch.ones(8, 16), torch.ones(8)
    with hlo_cost.CostMode() as mode:
        ops.BACKENDS["cuda"].matvec(X, c)
    assert mode.kernels == {} and mode.dot_flops == 0
    assert mode.cost.flops > 0              # the plain version's aten ops
