"""The CUDA kernels on the card, against their plain versions on the same
card, over the kernel sweep's shapes and batches; the wrappers' refusals;
and the sessions (default FISTA, ``cd``, groups) on the card against the
same sessions on the CPU.

Marked ``gpu``: without a CUDA device every test skips. On a machine with
one card: ``python -m pytest -q -m gpu tests/test_torch_cuda.py``.
(No JAX here: the machine with the card need not have it.)
"""

import numpy as np
import pytest
import torch

from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
from repro_torch.data import group_lasso_problem, lasso_problem
from repro_torch.kernels import (edpp_screen, group_screen, ops, ref,
                                 solver_step)

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
                                   "fista_step": launches,
                                   "group_screen_scores": 0,
                                   "cd_gram_sweep": 0}
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
    counts = ops.launch_counts()
    assert all(counts[op] > 0 for op in ("edpp_screen_scores",
                                         "screen_matvec", "fista_step"))
    assert counts["cd_gram_sweep"] == counts["group_screen_scores"] == 0
    assert not any(ops.plain_counts().values())
    res_c = LassoSession.fit(X, config=cfg, device="cpu").path(
        y, num_lambdas=20, hi_frac=0.95)
    assert gpu.fit_passes == 1 and gpu.backend_name == "cuda"
    np.testing.assert_allclose(res_g.lambdas, res_c.lambdas, rtol=2 ** -22)
    tol = 25.0 * float(np.sqrt(1e-6 * 0.5 * float(y @ y)))
    assert np.abs(res_g.betas - res_c.betas).max() <= tol
    # masks may differ only where a score rounds across the threshold
    assert (res_g.masks != res_c.masks).sum() <= 2


def _gram(cuda, b, seed):
    """G = AᵀA (exactly symmetric) with three zero columns."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    A = torch.randn(2 * b, b, generator=g, device=cuda)
    A[:, -3:] = 0.0
    G = A.T @ A
    return 0.5 * (G + G.T), g


@pytest.mark.parametrize("batch", [1, 3, 8, 9])
@pytest.mark.parametrize("b", [17, 32, 64, 130, 512, 1024])
def test_cd_gram_sweep_matches_plain_version(cuda, b, batch):
    """The reference's Gram CD tolerance, rtol 2e-4 / atol 2e-5: a
    rounding difference in q0 propagates along the sweeps' chain."""
    G, g = _gram(cuda, b, b * 10 + batch)
    lead = () if batch == 1 else (batch,)
    c = 0.1 * (torch.randn(*lead, b, generator=g, device=cuda) @ G)
    beta = 0.1 * torch.randn(*lead, b, generator=g, device=cuda)
    valid = None
    if batch > 1:
        valid = (torch.rand(batch, b, generator=g, device=cuda) > 0.3).float()
        beta = beta * valid
    lam = 0.5 * c.abs().amax(-1) if batch > 1 else 0.5 * float(c.abs().max())
    ops.reset_counts()
    out = solver_step.cd_gram_sweep(G, c, beta, lam, sweeps=3, valid=valid)
    want = ref.cd_gram_sweep_ref(G, c, beta, lam, sweeps=3, valid=valid)
    assert out.shape == want.shape == beta.shape
    assert bool(((out - want).abs() <= 2e-5 + 2e-4 * want.abs()).all())
    assert not out[..., -3:].any()
    if valid is not None:
        assert not (out * (1 - valid)).any()
    assert ops.launch_counts()["cd_gram_sweep"] == -(-batch // 8)


@pytest.mark.parametrize("shape, m", [((60, 300), 2), ((60, 300), 5),
                                      ((100, 1000), 10), ((777, 1000), 5),
                                      ((250, 20000), 20), ((60, 330), 33),
                                      ((40, 2200), 1100), ((7, 130), 1)])
def test_group_screen_matches_plain_version(cuda, shape, m):
    n, p = shape
    g = torch.Generator(device=cuda).manual_seed(n + p + m)
    X = torch.randn(n, p, generator=g, device=cuda)
    c = torch.randn(n, generator=g, device=cuda)
    ops.reset_counts()
    out = group_screen.group_screen_scores(X, c, m)
    _close((out,), (ref.group_screen_ref(X, c, m),))
    assert ops.launch_counts()["group_screen_scores"] == 1


def test_new_wrappers_refuse_bad_inputs_on_the_card(cuda):
    G, _ = _gram(cuda, 64, 0)
    v = torch.zeros(64, device=cuda)
    big = solver_step.GRAM_BUCKET_MAX + 1
    with pytest.raises(ValueError, match="GRAM_BUCKET_MAX"):
        solver_step.cd_gram_sweep(torch.zeros(big, big, device=cuda),
                                  torch.zeros(big, device=cuda),
                                  torch.zeros(big, device=cuda), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        solver_step.cd_gram_sweep(G.T[:, :].contiguous().T, v, v, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        solver_step.cd_gram_sweep(G, torch.zeros(128, device=cuda)[::2], v,
                                  0.1)
    X = torch.randn(20, 100, device=cuda)
    with pytest.raises(ValueError, match="must divide p"):
        group_screen.group_screen_scores(X, torch.zeros(20, device=cuda), 3)
    with pytest.raises(ValueError, match="contiguous"):
        group_screen.group_screen_scores(X[:, ::2], torch.zeros(20,
                                                               device=cuda), 5)
    with pytest.raises(ValueError, match="rank 1"):
        group_screen.group_screen_scores(X, torch.zeros(2, 20, device=cuda), 5)


def test_cd_and_group_sessions_on_the_card_match_the_cpu(cuda):
    X, y, _ = lasso_problem(100, 1000, nnz=10, seed=1, dtype=np.float32)
    tol = 25.0 * float(np.sqrt(1e-6 * 0.5 * float(y @ y)))
    cfg = PathConfig(solve=SolveSpec(strategy="cd", tol=1e-6))
    ops.reset_counts()
    res_g = LassoSession.fit(X, config=cfg).path(y, num_lambdas=20,
                                                 hi_frac=0.95)
    counts = ops.launch_counts()
    assert counts["cd_gram_sweep"] > 0 and not any(ops.plain_counts().values())
    res_c = LassoSession.fit(X, config=cfg, device="cpu").path(
        y, num_lambdas=20, hi_frac=0.95)
    assert np.abs(res_g.betas - res_c.betas).max() <= tol
    assert (res_g.masks != res_c.masks).sum() <= 2

    m = 5
    X, y, _ = group_lasso_problem(100, 1000, m, active_groups=4, seed=2,
                                  dtype=np.float32)
    tol = 25.0 * float(np.sqrt(1e-6 * 0.5 * float(y @ y)))
    for rule in ("edpp", "strong"):
        cfg = PathConfig(screen=ScreenSpec(rule=rule),
                         solve=SolveSpec(tol=1e-6))
        ops.reset_counts()
        sess = LassoSession.fit(X, groups=m, config=cfg)
        res_g = sess.path(y, num_lambdas=20, hi_frac=0.95)
        assert ops.launch_counts()["group_screen_scores"] > 0
        assert not any(ops.plain_counts().values())
        assert sess.fit_passes == 1 and sess.backend_name == "cuda"
        res_c = LassoSession.fit(X, groups=m, config=cfg, device="cpu").path(
            y, num_lambdas=20, hi_frac=0.95)
        np.testing.assert_allclose(res_g.lambdas, res_c.lambdas,
                                   rtol=2 ** -22)
        assert np.abs(res_g.betas - res_c.betas).max() <= tol
        assert (res_g.masks != res_c.masks).sum() <= 2
