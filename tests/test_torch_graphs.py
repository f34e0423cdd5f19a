"""The solver-loop helpers of ``repro_torch.core.graphs`` on the CPU.

On a CUDA tensor ``run_loop`` replays its blocks from a CUDA graph; that
path is held on the card by ``tests/test_torch_cuda.py`` (marked ``gpu``)
and ``chip_smoke.py``. Here: the parameter table's rows bit for bit the
host momentum sequence the eager solvers compute, ``run_loop`` on CPU
tensors as the plain loop it is there, the wrappers' ``params`` route to
the plain versions, and the count bookkeeping a replay uses.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import graphs
from repro_torch.core.solver import fista_momentum, fista_step_size
from repro_torch.kernels import ops, ref, solver_step


@pytest.mark.parametrize("dtype, fl", [(torch.float32, np.float32),
                                       (torch.float64, np.float64)])
def test_the_parameter_table_is_the_host_momentum_sequence(dtype, fl):
    """Row i holds step | λ | mom of iteration i: mom bit for bit the
    sequence fista_momentum gives an eager loop from t = 1, in the loop's
    own rounding (float32 for float32 X), step and λ in X's dtype."""
    X = torch.zeros(4, 6, dtype=dtype)
    step = fista_step_size(37.5, fl)
    table = graphs.param_table(300, step, 0.3, 2, X)
    assert table.shape == (300, 3, 2) and table.dtype == dtype
    t, moms = fl(1.0), []
    for _ in range(300):
        t, mom = fista_momentum(t, fl)
        moms.append(mom)
    want = torch.tensor(moms, dtype=dtype)
    assert torch.equal(table[:, 2], want[:, None].expand(300, 2))
    assert np.array_equal(graphs.momentum_sequence(300, fl),
                          np.array(moms, dtype=fl))
    assert torch.equal(table[:, 0], torch.full((300, 2), step, dtype=dtype))
    assert torch.equal(table[:, 1], torch.full((300, 2), 0.3, dtype=dtype))
    lam = torch.tensor([0.1, 0.2], dtype=dtype)
    per_query = graphs.param_table(5, step, lam, 2, X)
    assert torch.equal(per_query[:, 1], lam.expand(5, 2))


def _fista_body(X, y):
    def body(state, par):
        beta, z = state
        return solver_step.fista_step(X, X @ z - y, z, beta, params=par)
    return body


@pytest.mark.parametrize("capture", [True, False])
def test_run_loop_on_the_cpu_is_the_plain_loop(capture):
    """CPU tensors never capture: run_loop is the loop over the table's
    rows, bit for bit the eager FISTA loop with host step, λ and mom,
    one plain fista_step call per iteration."""
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.standard_normal((20, 50)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(20).astype(np.float32))
    step = fista_step_size(float(torch.linalg.matrix_norm(X, 2)) ** 2,
                           np.float32)
    zero = torch.zeros(50)
    ops.reset_counts()
    beta, z = graphs.run_loop(_fista_body(X, y), (zero, zero),
                              graphs.param_table(23, step, 0.5, 1, X),
                              capture=capture)
    assert ops.plain_counts()["fista_step"] == 23
    assert not any(ops.launch_counts().values())
    b, zz, t = zero, zero, np.float32(1.0)
    for _ in range(23):
        t, mom = fista_momentum(t, np.float32)
        b, zz = ref.fista_step_ref(X, X @ zz - y, zz, b, step, 0.5, mom)
    assert torch.equal(beta, b) and torch.equal(z, zz)


def test_wrappers_take_a_parameter_block_on_the_cpu():
    """``params`` (3, B) replaces step, λ, mom in both wrappers and their
    plain versions, with the same bits; a missing parameter or a block of
    the wrong shape raises."""
    rng = np.random.default_rng(4)
    X = torch.from_numpy(rng.standard_normal((10, 30)).astype(np.float32))
    r, z, b, parts = (
        torch.from_numpy(rng.standard_normal(k).astype(np.float32))
        for k in ((2, 10), (2, 30), (2, 30), (3, 2, 30)))
    block = torch.tensor([[0.01, 0.02], [0.5, 0.4], [0.6, 0.3]])
    for got, want in (
            (solver_step.fista_step(X, r, z, b, params=block),
             ref.fista_step_ref(X, r, z, b, block[0], block[1], block[2])),
            (solver_step.prox_step(z, parts, b, params=block),
             ref.prox_step_ref(z, parts[0] + parts[1] + parts[2], b,
                               block[0], block[1], block[2]))):
        for a, w in zip(got, want):
            assert torch.equal(a, w)
    with pytest.raises(TypeError, match="params"):
        ref.prox_step_ref(z, z, b, 0.1, 0.2)
    with pytest.raises(ValueError, match=r"\(3, 2\)"):
        ref.fista_step_ref(X, r, z, b, params=block[:, :1])


def test_add_counts_credits_and_takes_back():
    """What a replay adds and what a capture takes back: launches per op
    and plain-version calls, times a factor."""
    ops.reset_counts()
    ops.add_counts({"prox_step": 2, "fista_step": 1}, {"screen_matvec": 1},
                   times=3)
    assert ops.launch_counts()["prox_step"] == 6
    assert ops.launch_counts()["fista_step"] == 3
    assert ops.plain_counts()["screen_matvec"] == 3
    ops.add_counts({"prox_step": 2, "fista_step": 1}, {"screen_matvec": 1},
                   times=-3)
    assert not any(ops.launch_counts().values())
    assert not any(ops.plain_counts().values())
