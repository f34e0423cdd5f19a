"""The CUDA kernels on the card, against their plain versions on the same
card, over the kernel sweep's shapes and batches; and the session on the
card against the same session on the CPU.

Marked ``gpu``: without a CUDA device every test skips. On a machine with
one card: ``python -m pytest -q -m gpu tests/test_torch_cuda.py``.
(No JAX here: the machine with the card need not have it.)
"""

import numpy as np
import pytest
import torch

from repro_torch import LassoSession, PathConfig, SolveSpec
from repro_torch.data import lasso_problem
from repro_torch.kernels import edpp_screen, ops, ref, solver_step

pytestmark = pytest.mark.gpu

SHAPES = [(8, 128), (60, 300), (128, 512), (100, 1000), (7, 130), (256, 131),
          (777, 1001)]
BATCHES = [1, 3, 8, 17]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(kernel_out, plain_out):
    """Sums run in another order: 2e-5 of the output's scale."""
    for a, b in zip(kernel_out, plain_out):
        assert a.shape == b.shape and a.dtype == b.dtype
        tol = 2e-5 * max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= tol


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_versions(cuda, shape, batch):
    n, p = shape
    g = torch.Generator(device=cuda).manual_seed(n * p + batch)
    lead = () if batch == 1 else (batch,)

    def rand(*s):
        return torch.randn(*s, generator=g, device=cuda)

    X, c, z, b = rand(n, p), rand(*lead, n), rand(*lead, p), rand(*lead, p)
    per_q = torch.rand(batch, generator=g, device=cuda) if batch > 1 \
        else 0.4
    ops.reset_counts()
    _close(edpp_screen.edpp_screen_scores(X, c, per_q),
           ref.edpp_screen_ref(X, c, per_q))
    _close((edpp_screen.screen_matvec(X, c),),
           (ref.screen_matvec_ref(X, c),))
    _close(solver_step.fista_step(X, c, z, b, 1.0 / (n + p), per_q, 0.6),
           ref.fista_step_ref(X, c, z, b, 1.0 / (n + p), per_q, 0.6))
    launches = -(-batch // edpp_screen.MAX_B)
    assert ops.launch_counts() == {"edpp_screen_scores": launches,
                                   "screen_matvec": launches,
                                   "fista_step": launches}
    torch.cuda.synchronize()


def test_zero_columns_stay_zero_on_the_card(cuda):
    X = torch.randn(50, 96, device=cuda)
    X[:, 64:] = 0.0
    c = torch.randn(50, device=cuda)
    s, ss = edpp_screen.edpp_screen_scores(X, c, 0.5)
    assert not s[64:].any() and not ss[64:].any()
    z = torch.randn(96, device=cuda)
    z[64:] = 0.0
    bn, zn = solver_step.fista_step(X, c, z, z.clone(), 0.01, 0.3, 0.5)
    assert not bn[64:].any() and not zn[64:].any()


def test_session_on_the_card_matches_the_cpu(cuda):
    X, y, _ = lasso_problem(100, 1000, nnz=10, seed=0, dtype=np.float32)
    cfg = PathConfig(solve=SolveSpec(tol=1e-6))
    ops.reset_counts()
    gpu = LassoSession.fit(X, config=cfg)
    res_g = gpu.path(y, num_lambdas=20, hi_frac=0.95)
    assert all(v > 0 for v in ops.launch_counts().values())
    assert not any(ops.plain_counts().values())
    res_c = LassoSession.fit(X, config=cfg, device="cpu").path(
        y, num_lambdas=20, hi_frac=0.95)
    assert gpu.fit_passes == 1 and gpu.backend_name == "cuda"
    np.testing.assert_allclose(res_g.lambdas, res_c.lambdas, rtol=2 ** -22)
    tol = 25.0 * float(np.sqrt(1e-6 * 0.5 * float(y @ y)))
    assert np.abs(res_g.betas - res_c.betas).max() <= tol
    # masks may differ only where a score rounds across the threshold
    assert (res_g.masks != res_c.masks).sum() <= 2
