"""The CUDA kernels on the card, against their plain versions on the same
card, over the kernel sweep's shapes and batches; the column pass over
every branch of its launch plan (float4 and scalar loads, an unaligned
X, clusters, a centre staged in pieces), its repeatability and its exact
zero padding, and the bits of its MATVEC, SCORES and FISTA passes held
against digests of the PR 14 kernels; the group pass over every branch
of its plan (tiles of whole groups, scalar loads, clusters, a group
walked in steps) and the Gram CD sweep over both of its kernels (one
warp, one warp a chunk), each repeatable, blind to alignment and exact
on zero columns; the wrappers' refusals;
the sessions (default FISTA, ``cd``, groups, and (B, n) batches with
``fista`` and ``cd``) on the card against the same sessions on the CPU,
and batched screens (B = 8 and 12) bit for bit the single-query ones;
served masks at B = 8 through the serve loop, each the direct call's;
the other screening rules (GAP, strong, DOME, the cuts, hybrid): the
stacked cut matvecs (2 rows, and 16 in two launches) bit for bit their
rank-1 launches, batched screens bit for bit the single ones, and their
paths on the card against the CPU;
the prox step over its shapes and parameter kinds, and with a stack of
gradient parts bit for bit; solver loops
replayed from a CUDA graph (``repro_torch.core.graphs``) bit for bit
against the same launches run eagerly, with each replay's launches
counted; a mesh session over NCCL at world size 1 against the
unsharded session on the card, with ``dist_fista`` captured against
eager in its three modes; and the bf16 screen: ``screen_matvec`` on bf16
X against its plain version over 16-byte and scalar loads, clusters and
a staged centre (a zero column exactly 0; the same bits alone and in a
batch, and in two runs), the float32 re-test's gathers (``wide_p``) bit
for bit the wide pass at the gathered columns, and bf16 session paths
bit for bit the float32 paths; and the bf16 solve: ``fista_step`` on
bf16 X against its plain version over tiles of 32 and 128, clusters of
1 to 8, 16-byte and scalar loads and B = 1 to 9 (a zero column exactly
0, two launches and an unaligned copy the same bits, each row of a
batch the bits of its single launch), its refusals, and
``solve_dtype="bfloat16"`` sessions (fista and cd, one query and B = 8)
launching their kernels, against the float32 path and the CPU.

Marked ``gpu``: without a CUDA device every test skips. On a machine with
one card: ``python -m pytest -q -m gpu tests/test_torch_cuda.py``.
(No JAX here: the machine with the card need not have it.)
"""

import hashlib
import math
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
from repro_torch.core import DictionaryGeometry, ScreeningEngine, graphs
from repro_torch.data import QueryStream, group_lasso_problem, lasso_problem
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
                                   "cd_gram_sweep": 0, "prox_step": 0}
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


def _column_pass_inputs(cuda, n, p, batch, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    lead = () if batch == 1 else (batch,)

    def rand(*s):
        return torch.randn(*s, generator=g, device=cuda)

    per_q = torch.rand(batch, generator=g, device=cuda) if batch > 1 \
        else 0.4
    return rand(n, p), rand(*lead, n), rand(*lead, p), rand(*lead, p), per_q


def _column_passes(X, c, z, b, per_q, **kw):
    """The three column-pass kernels on one set of inputs."""
    n, p = X.shape
    return (*edpp_screen.edpp_screen_scores(X, c, per_q, **kw),
            edpp_screen.screen_matvec(X, c, **kw),
            *solver_step.fista_step(X, c, z, b, 1.0 / (n + p), per_q, 0.6,
                                    **kw))


def _unaligned(X):
    """A contiguous copy of X whose base pointer is 4 bytes past a 16-byte
    boundary (a view at storage offset 1)."""
    buf = torch.empty(X.numel() + 1, device=X.device)
    view = buf[1:].view(X.shape)
    view.copy_(X)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


# Shapes that reach every branch of the launch plan: p % 4 != 0, p < 32,
# p = 32 (a cluster of 8), the solver's buckets, a centre above the
# staging budget (20 000 and 40 000 rows), 3072 x 4096, the wide screen.
PLAN_SHAPES = [(777, 1001), (100, 20), (784, 32), (784, 512), (784, 4096),
               (20000, 256), (40000, 256), (3072, 4096), (784, 50000)]


@pytest.mark.parametrize("batch", [1, 3, 8, 9])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_column_pass_plans_match_plain_versions(cuda, shape, batch):
    """Every branch of the plan against the plain versions (2e-5 of
    scale); the same X at a base pointer 4 bytes off 16-byte alignment
    takes the scalar loads and gives the same bits; two launches on the
    same inputs give the same bits."""
    n, p = shape
    X, c, z, b, per_q = _column_pass_inputs(cuda, n, p, batch, n + p + batch)
    out = _column_passes(X, c, z, b, per_q)
    want = (*ref.edpp_screen_ref(X, c, per_q), ref.screen_matvec_ref(X, c),
            *ref.fista_step_ref(X, c, z, b, 1.0 / (n + p), per_q, 0.6))
    _close(out, want)
    again = _column_passes(X, c, z, b, per_q)
    assert all(torch.equal(a, w) for a, w in zip(out, again))
    Xu = _unaligned(X)
    assert edpp_screen.plan_for(Xu, min(batch, 8)).vec == 1
    assert all(torch.equal(a, w) for a, w in
               zip(_column_passes(Xu, c, z, b, per_q), out))
    if shape == (40000, 256) and batch >= 8:   # 160 KB of centre a CTA
        pl = edpp_screen.plan_for(X, 8)
        assert pl.stage_rows < -(-n // pl.split)
    del X, Xu
    torch.cuda.empty_cache()


@pytest.mark.parametrize("shape", [(784, 32), (777, 1001), (784, 50000)])
def test_column_pass_zero_padding_is_exact_on_the_card(cuda, shape):
    """Zero columns give exactly 0 on the float4, scalar and cluster paths,
    and zero rows (with a centre that is not 0 there) add nothing: the
    result equals the one without those rows, to the plain versions'
    tolerance, and stays exactly 0 in the zero columns."""
    n, p = shape
    X, c, z, b, per_q = _column_pass_inputs(cuda, n, p, 3, n + p)
    zc = torch.arange(0, p, 7, device=cuda)
    X[:, zc] = 0.0
    z[:, zc] = 0.0
    b[:, zc] = 0.0
    X[n // 2:n // 2 + 40] = 0.0
    for Xk in (X, _unaligned(X)):
        out = _column_passes(Xk, c, z, b, per_q)
        for o in out:
            assert not o[..., zc].any()
    live = torch.ones(n, dtype=torch.bool, device=cuda)
    live[n // 2:n // 2 + 40] = False
    _close(_column_passes(X, c, z, b, per_q),
           (*ref.edpp_screen_ref(X[live], c[:, live], per_q),
            ref.screen_matvec_ref(X[live], c[:, live]),
            *ref.fista_step_ref(X[live], c[:, live], z, b, 1.0 / (n + p),
                                per_q, 0.6)))


@pytest.mark.parametrize("shape", [(784, 32), (784, 512), (777, 1001)])
def test_cluster_and_single_cta_plans_agree(cuda, shape):
    """A plan whose rows are split over a cluster and the same tiles on one
    CTA each (``max_split=1``) agree to the sums' rounding, and one launch
    per call is counted either way."""
    n, p = shape
    X, c, z, b, per_q = _column_pass_inputs(cuda, n, p, 1, n * p)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    one = edpp_screen.launch_plan(n, p, 1, sms, X.data_ptr() % 16 == 0,
                                  max_split=1)
    assert edpp_screen.plan_for(X, 1).split > 1 and one.split == 1
    ops.reset_counts()
    _close(_column_passes(X, c, z, b, per_q, plan=one),
           _column_passes(X, c, z, b, per_q))
    assert ops.launch_counts()["fista_step"] == 2


def test_column_pass_refuses_a_plan_it_cannot_run(cuda):
    """float4 loads on an unaligned X, or on p % 4 != 0, and a cluster
    above 8 are refused by the C entry point: the wrapper raises."""
    X = torch.randn(64, 128, device=cuda)
    c = torch.randn(64, device=cuda)
    pl = edpp_screen.plan_for(X, 1)
    assert pl.vec == 4
    with pytest.raises(RuntimeError, match="cudaError_t"):
        edpp_screen.screen_matvec(_unaligned(X), c, plan=pl)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        edpp_screen.screen_matvec(X[:, :127].contiguous(), c, plan=pl)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        edpp_screen.screen_matvec(X, c, plan=pl._replace(split=16))
    torch.cuda.synchronize()


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


def _batch_problem(seed=3, batch=8, n=40, p=200):
    """tests/test_torch_batched.py's size: QueryStream(40, 200, B = 8) and
    per-query grids inside (0, λ_max)."""
    st = QueryStream(n=n, p=p, batch=batch, nnz=10, seed=seed)
    X = st.dictionary(np.float32)
    Y = st.host_batch(0)["y"].astype(np.float32)
    lmax = np.abs(Y.astype(np.float64) @ X.astype(np.float64)).max(axis=1)
    return X, Y, np.linspace(0.95, 0.05, 8)[None, :] * lmax[:, None]


@pytest.mark.parametrize("strategy", ["fista", "cd"])
def test_batched_path_on_the_card_matches_the_cpu(cuda, strategy):
    """The (B, n) path on the card: each kernel launched once per batched
    call (one ``screen_matvec`` per live step, plus the |Xᵀy| attach),
    no plain version; against the same path on the CPU, β within
    ``beta_err_tol`` per query and at most 2 mask flips; against the
    card's own single-query runs, masks equal."""
    X, Y, grids = _batch_problem()
    cfg = PathConfig(solve=SolveSpec(strategy=strategy, tol=1e-6))
    sess = LassoSession.fit(X, config=cfg)
    ops.reset_counts()
    res_g = sess.path(Y, grids)
    counts = ops.launch_counts()
    live = [s for s in res_g.stats if s.screen_backend]
    assert counts["screen_matvec"] == len(live) + 1
    kernel = "fista_step" if strategy == "fista" else "cd_gram_sweep"
    assert counts[kernel] > 0 and not any(ops.plain_counts().values())
    res_c = LassoSession.fit(X, config=cfg, device="cpu").path(Y, grids)
    assert (res_g.masks != res_c.masks).sum() <= 2
    for b in range(Y.shape[0]):
        tol = 25.0 * float(np.sqrt(1e-6 * 0.5 * float(Y[b] @ Y[b])))
        assert np.abs(res_g.betas[b] - res_c.betas[b]).max() <= tol
        one = sess.path(Y[b], grids[b])
        np.testing.assert_array_equal(res_g.masks[b], one.masks[0])
        assert np.abs(res_g.betas[b] - one.betas[0]).max() <= tol


@pytest.mark.parametrize("pad, tail", [("pow2", 4), ("full", 8)])
def test_served_masks_on_the_card_are_the_direct_calls(cuda, pad, tail):
    """The serve loop over a session on the card at B = 8 (two fill
    batches and a 3-live drain padded to ``tail``, the last query repeated
    into the padded lanes): every served mask equals a direct
    ``session.path`` call on its grid, bit for bit, and the batches ran on
    the kernels, no plain version."""
    from repro_torch.launch import serve_loop as sl
    st = QueryStream(n=100, p=2000, batch=8, nnz=10, seed=5)
    ys = list(st.queries(19, dtype=np.float32))
    sess = LassoSession.fit(st.dictionary(np.float32),
                            config=PathConfig(solve=SolveSpec(tol=1e-6)))
    ops.reset_counts()
    rep = sl.ServeLoop(
        sl.ScriptedArrivals([(0.0, y) for y in ys]),
        sl.SessionExecutor(sess, num_lambdas=16, hi_frac=0.95),
        policy=sl.ServePolicy(b_max=8, queue_cap=32, pad=pad),
        clock=sl.VirtualClock()).run()
    counts = ops.launch_counts()
    assert counts["screen_matvec"] > 0 and counts["fista_step"] > 0
    assert not any(ops.plain_counts().values())
    assert [(r.reason, r.n_live, r.padded_b) for r in rep.trace] \
        == [("fill", 8, 8), ("fill", 8, 8), ("drain", 3, tail)]
    assert rep.summary()["n_errors"] == 0
    for t in rep.tickets:
        direct = sess.path(ys[t.qid], t.result.lambdas)
        np.testing.assert_array_equal(direct.masks[0], t.result.masks)


@pytest.mark.parametrize("batch", [8, 12])
@pytest.mark.parametrize("rule", ["dpp", "imp1", "imp2", "edpp", "seq_safe",
                                  "safe"])
def test_batched_screens_on_the_card_are_the_single_screens(cuda, rule,
                                                            batch):
    """A batched screen on the card (two launches past MAX_B = 8) gives
    each query's single-query mask bit for bit, from the λ_max state."""
    X, Y, _ = _batch_problem(batch=batch)
    Xt, Yt = torch.from_numpy(X).to(cuda), torch.from_numpy(Y).to(cuda)
    geom = DictionaryGeometry(Xt)
    eng = ScreeningEngine(Xt, Yt, geometry=geom)
    lam = 0.5 * np.asarray(eng.lam_max)
    ops.reset_counts()
    got = eng.screen(lam, eng.state_at_lambda_max(), rule)
    assert ops.launch_counts()["screen_matvec"] == -(-batch // 8)
    for b in range(batch):
        one = ScreeningEngine(Xt, Yt[b].clone(), geometry=geom)
        assert one.lam_max == eng.lam_max[b]
        want = one.screen(float(lam[b]), one.state_at_lambda_max(), rule)
        assert torch.equal(got[b], want), (rule, b)


@pytest.mark.parametrize("rows", [2, 16])
def test_stacked_cut_matvecs_are_the_single_launches(cuda, rows):
    """The ``*_cut`` screens' stacked ``[centres; ĝ]`` matvec at 784 ×
    50 000: 2 rows (one query) in one launch, 16 rows (a B = 8 batch) in
    two launches of MAX_B = 8; every row bit for bit its own rank-1
    launch, and the stack within 2e-5 of scale of the plain version (it
    sums in another order)."""
    X = _det((784, 50000), 7).to(cuda)
    C = _det((rows, 784), 8).to(cuda)
    ops.reset_counts()
    got = edpp_screen.screen_matvec(X, C)
    assert ops.launch_counts()["screen_matvec"] == -(-rows // 8)
    for b in range(rows):
        assert torch.equal(got[b], edpp_screen.screen_matvec(X, C[b]
                                                             .clone())), b
    _close((got,), (ref.screen_matvec_ref(X, C),))
    del X, C, got
    torch.cuda.empty_cache()


NEW_RULES = ["gap", "strong", "dome", "edpp_cut", "gap_cut", "dpp_cut"]


@pytest.mark.parametrize("batch", [8, 12])
@pytest.mark.parametrize("rule", NEW_RULES)
def test_new_rules_batched_screens_on_the_card_are_the_single_screens(
        cuda, rule, batch):
    """GAP, strong, DOME and the cuts on the card: a batched screen from
    the λ_max state and from a sequential state gives each query's
    single-query mask bit for bit; its launches are the rule's passes,
    each split at MAX_B = 8 rows (a cut stacks 2B rows, DOME streams two
    passes of B)."""
    X, Y, _ = _batch_problem(batch=batch)
    Xt, Yt = torch.from_numpy(X).to(cuda), torch.from_numpy(Y).to(cuda)
    geom = DictionaryGeometry(Xt)
    eng = ScreeningEngine(Xt, Yt, geometry=geom)
    singles = [ScreeningEngine(Xt, Yt[b].clone(), geometry=geom)
               for b in range(batch)]
    lam_prev = 0.6 * np.asarray(eng.lam_max)
    beta = torch.zeros((batch, X.shape[1]), device=cuda)
    beta[:, :5] = 0.01
    fitted = beta @ Xt.T
    states = [(eng.state_at_lambda_max(),
               [s.state_at_lambda_max() for s in singles]),
              (eng.make_state(beta, lam_prev, fitted=fitted),
               [s.make_state(beta[b].clone(), float(lam_prev[b]),
                             fitted=fitted[b].clone())
                for b, s in enumerate(singles)])]
    rows = 2 * batch if rule.endswith("_cut") else batch
    launches = (2 if rule == "dome" else 1) * -(-rows // 8)
    lam = 0.5 * np.asarray(eng.lam_max)
    for state, per_query in states:
        ops.reset_counts()
        got = eng.screen(lam, state, rule)
        assert ops.launch_counts()["screen_matvec"] == launches
        assert not any(ops.plain_counts().values())
        for b in range(batch):
            want = singles[b].screen(float(lam[b]), per_query[b], rule)
            assert torch.equal(got[b], want), (rule, b)


@pytest.mark.parametrize("rule, strong", [
    ("gap", False), ("strong", False), ("dome", False), ("edpp_cut", False),
    ("gap_cut", False), ("edpp", True)])
def test_new_rules_on_the_card_match_the_cpu(cuda, rule, strong):
    """Each new rule's path on the card: ``screen_matvec`` and
    ``fista_step`` launched, no plain version called, β within
    ``beta_err_tol`` of the same session on the CPU, masks apart only
    where a score rounds across a threshold."""
    X, y, _ = lasso_problem(100, 1000, nnz=10, seed=0, dtype=np.float32)
    cfg = PathConfig(screen=ScreenSpec(rule=rule, strong=strong),
                     solve=SolveSpec(tol=1e-6))
    ops.reset_counts()
    gpu = LassoSession.fit(X, config=cfg)
    res_g = gpu.path(y, num_lambdas=20, hi_frac=0.95)
    counts = ops.launch_counts()
    assert counts["screen_matvec"] > 0 and counts["fista_step"] > 0
    assert not any(ops.plain_counts().values())
    res_c = LassoSession.fit(X, config=cfg, device="cpu").path(
        y, num_lambdas=20, hi_frac=0.95)
    tol = 25.0 * float(np.sqrt(1e-6 * 0.5 * float(y @ y)))
    assert np.abs(res_g.betas - res_c.betas).max() <= tol
    assert (res_g.masks != res_c.masks).sum() <= 2
    assert [s.x_passes for s in res_g.stats] \
        == [s.x_passes for s in res_c.stats]


@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("shape", [(1,), (4,), (50000,), (1003,), (3, 1003),
                                   (8, 50000), (17, 131)])
def test_prox_step_matches_plain_version(cuda, shape, per_query):
    """The kernel rounds each product and difference alone, as the plain
    version does: equal up to 1 ulp of the threshold step·λ (atol 1e-6
    at these magnitudes); zero columns stay 0; one launch per call."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + per_query)
    z, grad, b = (torch.randn(*shape, generator=g, device=cuda)
                  for _ in range(3))
    for a in (z, grad, b):
        a[..., -1:] = 0.0
    if per_query and len(shape) == 2:
        step, lam, mom = (torch.rand(shape[0], generator=g, device=cuda)
                          for _ in range(3))
    elif per_query:
        step, lam, mom = (torch.rand((), generator=g, device=cuda)
                          for _ in range(3))
    else:
        step, lam, mom = 0.01, 0.5, 0.6
    ops.reset_counts()
    out = solver_step.prox_step(z, grad, b, step, lam, mom)
    assert ops.launch_counts()["prox_step"] == 1
    want = ref.prox_step_ref(z, grad, b, step, lam, mom)
    torch.cuda.synchronize()
    for a, w in zip(out, want):
        assert a.shape == w.shape == z.shape and a.dtype == torch.float32
        assert float((a - w).abs().max()) <= 1e-6
        assert not a[..., -1:].any()
    # an unaligned view takes the scalar path and agrees as well
    zz, gg, bb = (a.reshape(-1)[1:].contiguous() for a in (z, grad, b))
    if zz.numel():
        for a, w in zip(solver_step.prox_step(zz, gg, bb, 0.01, 0.5, 0.6),
                        ref.prox_step_ref(zz, gg, bb, 0.01, 0.5, 0.6)):
            assert float((a - w).abs().max()) <= 1e-6


@pytest.mark.parametrize("parts", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(50000,), (8, 50000), (1003,), (3, 1003),
                                   (17, 131)])
def test_prox_step_sums_its_parts_bit_for_bit(cuda, shape, parts):
    """g as a stack of k parts: the kernel adds them in index order, each
    sum rounded alone, so with the parameters in a (3, B) device block
    it equals the plain version (the chained sum, then the prox) bit for
    bit, on float4 loads and on an unaligned view's scalar loads alike;
    one launch per call."""
    B = shape[0] if len(shape) == 2 else 1
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + parts)
    z, b = (torch.randn(*shape, generator=g, device=cuda) for _ in range(2))
    stack = torch.randn(parts, *shape, generator=g, device=cuda)
    par = torch.stack([torch.rand(B, generator=g, device=cuda) * 0.5,
                       torch.rand(B, generator=g, device=cuda),
                       torch.rand(B, generator=g, device=cuda)])
    ops.reset_counts()
    out = solver_step.prox_step(z, stack, b, params=par)
    assert ops.launch_counts()["prox_step"] == 1
    chained = stack[0]
    for part in stack[1:]:
        chained = chained + part
    for want in (ref.prox_step_ref(z, stack, b, params=par),
                 ref.prox_step_ref(z, chained, b, params=par),
                 solver_step.prox_step(z, chained, b, params=par)):
        for a, w in zip(out, want):
            assert a.shape == z.shape and torch.equal(a, w)
    flat = (z.reshape(-1)[1:].contiguous(), stack.reshape(parts, -1)[:, 1:]
            .contiguous(), b.reshape(-1)[1:].contiguous())
    one = par[:, :1].contiguous()
    for a, w in zip(solver_step.prox_step(*flat, params=one),
                    ref.prox_step_ref(*flat, params=one)):
        assert torch.equal(a, w)
    with pytest.raises(ValueError, match="gradient parts"):
        solver_step.prox_step(z, torch.zeros(9, *shape, device=cuda), b,
                              params=par)
    with pytest.raises(ValueError, match="params"):
        solver_step.prox_step(z, stack, b, params=par[:2])


def _loop_problem(cuda, n=96, p=4000, parts=4):
    """A single-query FISTA loop on the card whose body launches
    ``fista_step`` and then ``prox_step`` on a (parts, p) stack, each
    reading its parameters from the table's row."""
    g = torch.Generator(device=cuda).manual_seed(n + p)
    X = torch.randn(n, p, generator=g, device=cuda) / math.sqrt(n)
    y = torch.randn(n, generator=g, device=cuda)
    step = 1.0 / (1.05 * float(torch.linalg.matrix_norm(X, 2)) ** 2)
    bounds = [(lo, min(n, lo + n // parts)) for lo in range(0, n, n // parts)]
    stack = torch.empty(len(bounds), p, device=cuda)

    def body(state, par):
        beta, z = state
        beta, z = solver_step.fista_step(X, X @ z - y, z, beta, params=par)
        for c, (lo, hi) in enumerate(bounds):
            torch.matmul(X[lo:hi].T, X[lo:hi] @ z - y[lo:hi], out=stack[c])
        return solver_step.prox_step(z, stack, beta, params=par)

    def table(iters):
        return graphs.param_table(iters, step, 0.2 * float((X.T @ y).abs()
                                                           .max()), 1, X)
    return body, table, torch.zeros(p, device=cuda)


@pytest.mark.parametrize("iters", [51, 13, 6, 3])
def test_a_captured_block_replays_the_eager_launches(cuda, iters):
    """run_loop captured (an eager prefix of 1 + (iters − 1) % BLOCK, then
    replays of one block: at BLOCK = 5, 10, 2, 1 and none) against
    capture=False on the same table: β and z equal bit for bit, and
    launch_counts() credits each replay with the block's launches, so
    both count one fista_step and one prox_step per iteration and nothing
    for the capture itself."""
    body, table, zero = _loop_problem(cuda)
    rows = table(iters)
    runs = {}
    for capture in (False, True):
        ops.reset_counts()
        runs[capture] = graphs.run_loop(body, (zero, zero), rows,
                                        capture=capture)
        torch.cuda.synchronize()
        assert ops.launch_counts() == dict(
            dict.fromkeys(ops.OPS, 0), fista_step=iters, prox_step=iters)
        assert not any(ops.plain_counts().values())
    for a, b in zip(runs[True], runs[False]):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(runs[True][0]).all())
    assert runs[True][0].abs().max() > 0


def test_the_parameter_table_is_the_host_momentum_sequence(cuda):
    """The table's rows on the card: step and λ in every row, mom the host
    fista_momentum sequence, all as float32 bits; a (B,) λ on the card is
    copied in per query."""
    X = torch.zeros(3, 4, device=cuda)
    lam = torch.tensor([0.25, 0.5], device=cuda)
    t = graphs.param_table(7, 0.125, lam, 2, X)
    assert t.shape == (7, 3, 2) and t.dtype == torch.float32 and t.is_cuda
    moms = graphs.momentum_sequence(7, np.float32)
    assert np.array_equal(t[:, 2].cpu().numpy(), np.stack([moms] * 2, 1))
    assert torch.equal(t[:, 1], lam.expand(7, 2))
    assert bool((t[:, 0] == 0.125).all())


def test_mesh_session_over_nccl_matches_the_unsharded_session(cuda, tmp_path):
    """World size 1 over NCCL: the mesh session's masks, β and pass
    counts equal the unsharded session's on the card, bit for bit, and
    dist_fista("chunked") launches prox_step once per iteration."""
    from repro_torch.core import distributed as D
    X, y, _ = lasso_problem(100, 1000, nnz=10, seed=0, dtype=np.float32)
    cfg = PathConfig(solve=SolveSpec(tol=1e-6))
    plain = LassoSession.fit(X, config=cfg)
    res_u = plain.path(y, num_lambdas=20, hi_frac=0.95)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp_path, "store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", 0))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("query", "feature"))
        sess = LassoSession.fit(X, mesh=mesh, config=cfg)
        res_m = sess.path(y, num_lambdas=20, hi_frac=0.95)
        assert sess.backend_name == "shard:cuda" and sess.fit_passes == 1
        np.testing.assert_array_equal(res_m.masks, res_u.masks)
        np.testing.assert_array_equal(res_m.betas, res_u.betas)
        assert [s.x_passes for s in res_m.stats] \
            == [s.x_passes for s in res_u.stats]
        Xl, yt = D.shard_problem(mesh, X, y)
        ops.reset_counts()
        lam = 0.3 * float(plain.geometry.backend.matvec(
            plain.X, yt).abs().max())
        beta = D.dist_fista(mesh, Xl, yt, lam, torch.zeros(1000, device=cuda),
                            1.05 * float(D.dist_power_iteration(mesh, Xl)),
                            iters=50, overlap="chunked")
        assert ops.launch_counts()["prox_step"] == 50
        assert not any(ops.plain_counts().values())
        assert bool(torch.isfinite(beta).all())
        # the iterations replayed from a CUDA graph, collectives included,
        # give the eager loop's bits in every mode
        L = 1.05 * float(D.dist_power_iteration(mesh, Xl))
        for mode, iters in (("none", 60), ("chunked", 60), ("stale", 30)):
            runs = {}
            for capture in (True, False):
                ops.reset_counts()
                runs[capture] = D.dist_fista(
                    mesh, Xl, yt, lam, torch.zeros(1000, device=cuda), L,
                    iters=iters, overlap=mode, capture=capture)
                torch.cuda.synchronize()
                op = "fista_step" if mode == "none" else "prox_step"
                assert ops.launch_counts()[op] == iters, (mode, capture)
            assert torch.equal(runs[True], runs[False]), mode
    finally:
        dist.destroy_process_group()


def _det(shape, salt):
    """Float32 values in [-1, 1] from integer arithmetic: the same bits on
    every machine, whatever its random number generators."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64)
    v = (idx * 7919 + salt * 104729) % 2003 - 1001
    return (v.double() / 1001.0).float().reshape(shape)


# Shapes and batches whose pinned plans (132 SMs, aligned) reach float4 and
# scalar loads, clusters of 8, 4 and 2, and the wide one-wave tiles.
DIGEST_CASES = [(777, 1001, 3), (784, 32, 1), (784, 512, 8), (256, 4096, 1),
                (100, 20, 2), (784, 50000, 1)]
# column_pass_digests of the PR 14 kernels (the parent of the GROUP
# epilogue), taken on an NVIDIA H100 80GB HBM3
PR14_DIGESTS = {"777x1001xB3": "72081f00e49b47e3",
                "784x32xB1": "c9124d8bd5cbbe08",
                "784x512xB8": "5b6649e00f3c1485",
                "256x4096xB1": "dc86589e3830ce31",
                "100x20xB2": "03b69187376a780e",
                "784x50000xB1": "f786bd55bd6baae0"}


def column_pass_digests(edpp_screen, solver_step, device="cuda"):
    """SHA-256 (16 hex digits) of the SCORES, MATVEC and FISTA outputs at
    each of DIGEST_CASES, every launch on the plan ``launch_plan`` picks
    for 132 SMs: the bits of the three column passes, comparable across
    trees and cards."""
    out = {}
    for n, p, B in DIGEST_CASES:
        lead = () if B == 1 else (B,)
        X = _det((n, p), 1).to(device)
        c, z, b = (_det(lead + (k,), s).to(device)
                   for k, s in ((n, 2), (p, 3), (p, 4)))
        per_q = torch.linspace(0.2, 0.9, B, device=device) if B > 1 else 0.4
        pl = edpp_screen.launch_plan(n, p, B, 132, True)
        outs = (*edpp_screen.edpp_screen_scores(X, c, per_q, plan=pl),
                edpp_screen.screen_matvec(X, c, plan=pl),
                *solver_step.fista_step(X, c, z, b, 1.0 / (n + p), per_q, 0.6,
                                        plan=pl))
        h = hashlib.sha256()
        for o in outs:
            h.update(o.cpu().numpy().tobytes())
        out[f"{n}x{p}xB{B}"] = h.hexdigest()[:16]
    return out


def test_column_pass_bits_are_those_of_the_pr14_kernels(cuda):
    """The GROUP epilogue shares the template: MATVEC, SCORES and FISTA
    must keep every bit they had before it."""
    assert column_pass_digests(edpp_screen, solver_step) == PR14_DIGESTS


# Shapes and group sizes that reach every branch of the group plan: tiles
# of 120 columns (float4, wide and clustered), p % 4 != 0 with a cluster
# of 4, m = 33 (99-column tiles, scalar loads), groups of 200 and 1 100
# walked in steps, groups of one column, a cluster of 2 at m = 20, and a
# centre staged in pieces (200 000 rows).
GROUP_PLAN_SHAPES = [((250, 20000), 10), ((250, 2400), 10),
                     ((777, 1001), 7), ((60, 330), 33), ((250, 20000), 200),
                     ((40, 2200), 1100), ((7, 130), 1), ((784, 240), 20),
                     ((200000, 120), 5), ((250, 200000), 10)]


@pytest.mark.parametrize("shape, m", GROUP_PLAN_SHAPES)
def test_group_pass_plans_match_plain_version(cuda, shape, m):
    """Every branch of the group plan against the plain version (2e-5 of
    scale), one launch a call; two launches give the same bits, and the
    same X 4 bytes off 16-byte alignment (scalar loads, the same tiles)
    gives the same bits as well."""
    n, p = shape
    X, c = (_det(s, k).to(cuda) for s, k in (((n, p), 5), ((n,), 6)))
    ops.reset_counts()
    out = group_screen.group_screen_scores(X, c, m)
    assert ops.launch_counts()["group_screen_scores"] == 1
    _close((out,), (ref.group_screen_ref(X, c, m),))
    assert torch.equal(out, group_screen.group_screen_scores(X, c, m))
    Xu = _unaligned(X)
    assert group_screen.group_plan_for(Xu, m).vec == 1
    assert torch.equal(group_screen.group_screen_scores(Xu, c, m), out)
    if shape == (200000, 120):
        pl = group_screen.group_plan_for(X, m)
        assert pl.split > 1 and pl.stage_rows < -(-n // pl.split)
    del X, Xu
    torch.cuda.empty_cache()


@pytest.mark.parametrize("shape, m", [((250, 2400), 10), ((777, 1001), 7),
                                      ((250, 2000), 200), ((60, 330), 33)])
def test_group_pass_zero_padding_is_exact(cuda, shape, m):
    """Groups of zero columns score exactly 0, on every plan branch; zero
    rows (with a centre that is not 0 there) add nothing; the clustered
    plans agree with the same tiles on one CTA each."""
    n, p = shape
    g = torch.Generator(device=cuda).manual_seed(n + p + m)
    X = torch.randn(n, p, generator=g, device=cuda)
    c = torch.randn(n, generator=g, device=cuda)
    dead = torch.arange(0, p // m, 3, device=cuda)
    X.view(n, p // m, m)[:, dead] = 0.0
    X[n // 2:n // 2 + 20] = 0.0
    out = group_screen.group_screen_scores(X, c, m)
    assert not out[dead].any()
    live = torch.ones(n, dtype=torch.bool, device=cuda)
    live[n // 2:n // 2 + 20] = False
    _close((out,), (ref.group_screen_ref(X[live], c[live], m),))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    one = group_screen.group_plan(n, p, m, sms, X.data_ptr() % 16 == 0,
                                  max_split=1)
    _close((group_screen.group_screen_scores(X, c, m, plan=one),), (out,))


def test_group_pass_refuses_a_plan_it_cannot_run(cuda):
    """A tile that cuts a group, a cluster whose ranks would cut one,
    float4 loads on an unaligned X or on 99-column tiles: the C entry
    point refuses, the wrapper raises."""
    X = torch.randn(64, 1200, device=cuda)
    c = torch.randn(64, device=cuda)
    pl = group_screen.group_plan_for(X, 10)
    assert (pl.vec, pl.tile) == (4, 120)
    for bad in (pl._replace(tile=128), pl._replace(split=8),
                pl._replace(tile=240)):
        with pytest.raises(RuntimeError, match="cudaError_t"):
            group_screen.group_screen_scores(X, c, 10, plan=bad)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        group_screen.group_screen_scores(_unaligned(X), c, 10, plan=pl)
    X33 = torch.randn(64, 990, device=cuda)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        group_screen.group_screen_scores(
            X33, c, 33, plan=group_screen.group_plan_for(X33, 33)._replace(
                vec=4))
    torch.cuda.synchronize()


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("b", [5, 32, 33, 96, 1000, 1024])
def test_cd_gram_sweep_is_repeatable_and_blind_to_alignment(cuda, b, batch):
    """Both kernels (one warp for p <= 32, one warp a chunk above): two
    launches give the same bits, a G 4 bytes off 16-byte alignment gives
    them too, both match the plain version, and the
    zero-Gram and screened-out columns stay exactly 0."""
    G, g = _gram(cuda, b, b + batch)
    lead = () if batch == 1 else (batch,)
    c = 0.1 * (torch.randn(*lead, b, generator=g, device=cuda) @ G)
    beta = 0.1 * torch.randn(*lead, b, generator=g, device=cuda)
    valid = (torch.rand(*lead, b, generator=g, device=cuda) > 0.3).float()
    beta = beta * valid
    lam = 0.5 * c.abs().amax(-1) if batch > 1 else 0.5 * float(c.abs().max())
    out = solver_step.cd_gram_sweep(G, c, beta, lam, sweeps=4, valid=valid)
    want = ref.cd_gram_sweep_ref(G, c, beta, lam, sweeps=4, valid=valid)
    assert bool(((out - want).abs() <= 2e-5 + 2e-4 * want.abs()).all())
    assert torch.equal(out, solver_step.cd_gram_sweep(G, c, beta, lam,
                                                      sweeps=4, valid=valid))
    Gu = _unaligned(G)
    assert torch.equal(out, solver_step.cd_gram_sweep(Gu, c, beta, lam,
                                                      sweeps=4, valid=valid))
    assert not out[..., -3:].any() and not (out * (1 - valid)).any()
    assert torch.equal(solver_step.cd_gram_sweep(G, c, beta, lam, sweeps=0),
                       beta)


# ---------------------------------------------------------------------------
# the mixed-precision screen: screen_matvec on bf16 X, the float32 re-test
# ---------------------------------------------------------------------------

def _unaligned_bf16(X):
    """A contiguous bf16 copy of X whose base pointer is 2 bytes past a
    16-byte boundary."""
    buf = torch.empty(X.numel() + 1, dtype=torch.bfloat16, device=X.device)
    view = buf[1:].view(X.shape)
    view.copy_(X)
    assert view.is_contiguous() and view.data_ptr() % 16 == 2
    return view


# 16-byte loads and wide tiles (784 x 50 000), ragged p (scalar loads),
# p < 32, a cluster of 4 at 32 columns, the solver's buckets, a centre
# staged in pieces of 64 rows (20 000 rows)
BF16_SHAPES = [(784, 50000), (777, 1001), (100, 20), (784, 32), (784, 512),
               (20000, 256), (3072, 4096)]


@pytest.mark.parametrize("batch", [1, 3, 8, 9])
@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_bf16_matvec_matches_plain_version(cuda, shape, batch):
    """``screen_matvec`` on bf16 X against its plain version (float32 sums
    over ``X.float()``; 2e-5 of scale, the sums run in another order);
    scalar loads on an unaligned copy give the same bits; a zero column
    gives exactly 0; each launch counts as ``screen_matvec_bf16``."""
    n, p = shape
    g = torch.Generator(device=cuda).manual_seed(n + p + batch)
    X = torch.randn(n, p, generator=g, device=cuda).to(torch.bfloat16)
    X[:, p // 2] = 0.0
    lead = () if batch == 1 else (batch,)
    c = torch.randn(*lead, n, generator=g, device=cuda)
    ops.reset_counts()
    got = edpp_screen.screen_matvec(X, c)
    launches = -(-batch // edpp_screen.MAX_B)
    assert ops.launch_counts()["screen_matvec_bf16"] == launches
    assert ops.launch_counts()["screen_matvec"] == 0
    assert got.dtype == torch.float32
    _close((got,), (ref.screen_matvec_ref(X, c),))
    assert not got[..., p // 2].any()
    pl = edpp_screen.plan_for(X, min(batch, 8))
    assert pl.vec == (8 if p % 8 == 0 else 1)
    Xu = _unaligned_bf16(X)
    assert edpp_screen.plan_for(Xu, min(batch, 8)).vec == 1
    assert torch.equal(edpp_screen.screen_matvec(Xu, c), got)
    del X, Xu
    torch.cuda.empty_cache()


@pytest.mark.parametrize("shape", [(784, 50000), (777, 1001), (784, 512)])
def test_bf16_matvec_bits_do_not_depend_on_the_batch_or_the_run(cuda, shape):
    """A query's bf16 dots are the same bits alone and inside a batch of
    8, and in two runs."""
    n, p = shape
    X = _det((n, p), 11).to(cuda).to(torch.bfloat16)
    C = _det((8, n), 12).to(cuda)
    got = edpp_screen.screen_matvec(X, C)
    assert torch.equal(edpp_screen.screen_matvec(X, C), got)
    for b in range(8):
        assert torch.equal(edpp_screen.screen_matvec(X, C[b].clone()),
                           got[b]), b


@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("k", [8, 24, 48])
@pytest.mark.parametrize("shape", [(784, 50000), (784, 4096), (777, 1001),
                                   (20000, 256)])
def test_retest_gathers_give_the_wide_float32_bits(cuda, shape, k, rows):
    """The float32 re-test: an (n, k) gather of X's columns, zero-padded to
    its bucket, launched with ``wide_p=p`` (the wide pass's tile and
    cluster) gives the wide pass's dots at the gathered columns bit for
    bit, for one centre, 8 rows and 16 (two launches)."""
    from repro_torch.core.engine import _narrow_bucket
    n, p = shape
    X = _det((n, p), 13).to(cuda)
    lead = () if rows == 1 else (rows,)
    C = _det(lead + (n,), 14).to(cuda)
    full = edpp_screen.screen_matvec(X, C)
    cols = torch.from_numpy(np.sort(np.random.default_rng(k + rows)
                                    .choice(p, k, replace=False))).to(cuda)
    bucket = _narrow_bucket(k + 1, p)
    Xn = torch.zeros((n, bucket), device=cuda)
    Xn[:, :k] = X[:, cols]
    got = edpp_screen.screen_matvec(Xn, C, wide_p=p)
    assert torch.equal(got[..., :k], full[..., cols])
    assert not got[..., k:].any()
    wide = edpp_screen.plan_for(X, min(rows, 8))
    pl = edpp_screen.plan_for(Xn, min(rows, 8), wide_p=p)
    assert (pl.tile, pl.split) == (wide.tile, wide.split)
    del X, Xn
    torch.cuda.empty_cache()


def test_bf16_matvec_refuses_what_it_does_not_take(cuda):
    X = torch.randn(64, 128, device=cuda).to(torch.bfloat16)
    c = torch.randn(64, device=cuda)
    with pytest.raises(ValueError, match="wide_p"):
        edpp_screen.screen_matvec(X, c, wide_p=256)
    pl = edpp_screen.plan_for(X, 1)
    assert pl.vec == 8
    with pytest.raises(RuntimeError, match="cudaError_t"):   # float4 width
        edpp_screen.screen_matvec(X, c, plan=pl._replace(vec=4))
    with pytest.raises(RuntimeError, match="cudaError_t"):   # p % 8 != 0
        edpp_screen.screen_matvec(X[:, :124].contiguous(), c, plan=pl)
    with pytest.raises(TypeError, match="float32"):
        edpp_screen.edpp_screen_scores(X, c, 0.5)
    torch.cuda.synchronize()


@pytest.mark.parametrize("rule", ["edpp", "gap", "gap_cut", "dome", "strong",
                                  "safe"])
def test_bf16_paths_on_the_card_are_the_float32_paths(cuda, rule):
    """A bf16 session path on the card, one query and a batch of 8: masks
    and β the float32 path's bit for bit, every screened step in bf16 on
    ``screen_matvec_bf16``, no plain version called."""
    X, Y, _ = _batch_problem(batch=8, n=100, p=2000)
    sess = LassoSession.fit(X)
    for Yq in (Y[0], Y):
        out = {}
        for dtype in ("float32", "bfloat16"):
            cfg = PathConfig(screen=ScreenSpec(
                rule=rule, sequential=rule not in ("dome", "safe"),
                screen_dtype=dtype), solve=SolveSpec(tol=1e-6))
            sess.reset_solver_cache()
            ops.reset_counts()
            out[dtype] = sess.path(Yq, num_lambdas=20, config=cfg)
            counts = ops.launch_counts()
            assert not any(ops.plain_counts().values())
        assert counts.get("screen_matvec_bf16", 0) > 0
        np.testing.assert_array_equal(out["bfloat16"].masks,
                                      out["float32"].masks)
        np.testing.assert_array_equal(out["bfloat16"].betas,
                                      out["float32"].betas)
        live = [s for s in out["bfloat16"].stats if s.screen_backend]
        assert all(s.screen_dtype_effective == "bfloat16" for s in live)


# ---------------------------------------------------------------------------
# the mixed-precision solve: fista_step on bf16 X, bf16 session solves
# ---------------------------------------------------------------------------

# the solver's buckets (784 x 32 on a cluster of 4: 196 rows a rank; 512;
# 4096), ragged p (scalar loads), p < 32, the unscreened width (tiles of
# 128, one CTA a tile) and a centre staged in pieces (20 000 rows)
BF16_FISTA_SHAPES = [(784, 32), (784, 128), (784, 512), (784, 4096),
                     (777, 1001), (100, 20), (784, 50000), (20000, 256)]


def _bf16_fista_inputs(cuda, n, p, batch, seed):
    X, c, z, b, per_q = _column_pass_inputs(cuda, n, p, batch, seed)
    X = X.to(torch.bfloat16)
    X[:, p // 2] = 0.0
    z[..., p // 2] = 0.0
    b[..., p // 2] = 0.0
    return X, c, z, b, per_q


@pytest.mark.parametrize("batch", [1, 3, 8, 9])
@pytest.mark.parametrize("shape", BF16_FISTA_SHAPES)
def test_bf16_fista_step_matches_plain_version(cuda, shape, batch):
    """``fista_step`` on bf16 X (r, z, β_old float32) against its plain
    version (float32 sums over ``X.float()``; 2e-5 of scale): each launch
    counted as ``fista_step_bf16``, a zero column exactly 0, and the
    scalar loads of an unaligned copy and a second launch the same
    bits."""
    n, p = shape
    X, c, z, b, per_q = _bf16_fista_inputs(cuda, n, p, batch, n + 3 * p)
    step = 1.0 / (n + p)
    ops.reset_counts()
    out = solver_step.fista_step(X, c, z, b, step, per_q, 0.6)
    launches = -(-batch // edpp_screen.MAX_B)
    assert ops.launch_counts()["fista_step_bf16"] == launches
    assert ops.launch_counts()["fista_step"] == 0
    assert all(o.dtype == torch.float32 for o in out)
    _close(out, ref.fista_step_ref(X, c, z, b, step, per_q, 0.6))
    assert not any(o[..., p // 2].any() for o in out)
    pl = edpp_screen.plan_for(X, min(batch, 8))
    assert pl.vec == (8 if p % 8 == 0 else 1)
    again = solver_step.fista_step(X, c, z, b, step, per_q, 0.6)
    assert all(torch.equal(a, o) for a, o in zip(again, out))
    Xu = _unaligned_bf16(X)
    assert edpp_screen.plan_for(Xu, min(batch, 8)).vec == 1
    assert all(torch.equal(a, o) for a, o in zip(
        solver_step.fista_step(Xu, c, z, b, step, per_q, 0.6), out))
    del X, Xu
    torch.cuda.empty_cache()


@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(784, 32), (784, 512), (777, 1001)])
def test_bf16_fista_step_over_tiles_and_clusters(cuda, shape, split, tile):
    """Every tile and cluster the plan can take, forced through ``plan=``
    (rows split over 1 to 8 CTAs, 98 a rank at 784 rows and 8), with 16-byte
    or scalar loads and B = 1 and 8, against the plain version."""
    n, p = shape
    for batch in (1, 8):
        X, c, z, b, per_q = _bf16_fista_inputs(cuda, n, p, batch, split)
        vec = 8 if p % 8 == 0 else 1
        pl = edpp_screen.finish_plan(n, p, batch, vec, tile, split, tile,
                                     quantum=64)
        out = solver_step.fista_step(X, c, z, b, 0.01, per_q, 0.6, plan=pl)
        _close(out, ref.fista_step_ref(X, c, z, b, 0.01, per_q, 0.6))


@pytest.mark.parametrize("shape", [(784, 32), (784, 128), (784, 512),
                                   (777, 1001), (784, 50000)])
def test_bf16_fista_step_bits_do_not_depend_on_the_batch(cuda, shape):
    """A query's β' and z' on bf16 X are the same bits alone and as a row
    of a batch of 8 (its step | λ | mom from a (3, B) block or by value),
    and in two runs."""
    n, p = shape
    X = _det((n, p), 21).to(cuda).to(torch.bfloat16)
    R, Z, Bo = (_det((8, k), s).to(cuda) for k, s in ((n, 22), (p, 23),
                                                      (p, 24)))
    lam = torch.linspace(0.2, 0.9, 8, device=cuda)
    par = torch.stack([torch.full((8,), 1e-3, device=cuda), lam,
                       torch.full((8,), 0.6, device=cuda)])
    got = solver_step.fista_step(X, R, Z, Bo, params=par)
    again = solver_step.fista_step(X, R, Z, Bo, params=par)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    for q in range(8):
        one = solver_step.fista_step(X, R[q].clone(), Z[q].clone(),
                                     Bo[q].clone(), 1e-3, float(lam[q]), 0.6)
        assert torch.equal(one[0], got[0][q]) and torch.equal(one[1],
                                                              got[1][q]), q


def test_bf16_fista_step_refuses_what_it_does_not_take(cuda):
    X = torch.randn(64, 128, device=cuda).to(torch.bfloat16)
    r, z = torch.randn(64, device=cuda), torch.randn(128, device=cuda)
    pl = edpp_screen.plan_for(X, 1)
    assert pl.vec == 8
    with pytest.raises(RuntimeError, match="cudaError_t"):   # float4 width
        solver_step.fista_step(X, r, z, z, 0.1, 0.1, 0.1,
                               plan=pl._replace(vec=4))
    with pytest.raises(RuntimeError, match="cudaError_t"):   # p % 8 != 0
        solver_step.fista_step(X[:, :124].contiguous(), r, z[:124],
                               z[:124], 0.1, 0.1, 0.1, plan=pl)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        solver_step.fista_step(X.to(torch.float16), r, z, z, 0.1, 0.1, 0.1)
    with pytest.raises(TypeError, match="r must be float32"):
        solver_step.fista_step(X, r.to(torch.bfloat16), z, z, 0.1, 0.1, 0.1)
    torch.cuda.synchronize()


@pytest.mark.parametrize("strategy", ["fista", "cd"])
def test_bf16_solve_session_on_the_card_runs_its_kernels(cuda, strategy):
    """``solve_dtype="bfloat16"`` on the card, one query and a batch of 8:
    FISTA launches ``fista_step_bf16`` (and the float32 ``fista_step`` for
    its polish), Gram CD ``cd_gram_sweep``, no plain version is called;
    the live steps report bf16 with bf16-phase iterations; β within
    beta_err_tol of the float32 path's and of the CPU bf16 path's, masks
    nearly equal."""
    X, Y, _ = _batch_problem(batch=8, n=100, p=2000)
    sess = LassoSession.fit(X)
    cpu = LassoSession.fit(X, device="cpu")
    for Yq in (Y[0], Y):
        out = {}
        for dtype in ("float32", "bfloat16"):
            cfg = PathConfig(solve=SolveSpec(strategy=strategy, tol=1e-6,
                                             solve_dtype=dtype))
            sess.reset_solver_cache()
            ops.reset_counts()
            out[dtype] = sess.path(Yq, num_lambdas=20, config=cfg)
            counts = ops.launch_counts()
            assert not any(ops.plain_counts().values())
        if strategy == "fista":
            assert counts.get("fista_step_bf16", 0) > 0
        else:
            assert counts["cd_gram_sweep"] > 0
            assert counts.get("fista_step_bf16", 0) == 0
        res_c = cpu.path(Yq, num_lambdas=20, config=cfg)
        r16, r32 = out["bfloat16"], out["float32"]
        live = [s for s in r16.stats if s.screen_backend]
        bf = [s for s in live if strategy == "fista" or s.bucket <= 100]
        assert bf and all(s.solve_dtype_effective == "bfloat16"
                          and s.solver_lo_iters > 0 for s in bf)
        Ys = Yq.reshape(-1, Yq.shape[-1])
        for q in range(Ys.shape[0]):
            tol = 25.0 * float(np.sqrt(1e-6 * 0.5 * float(Ys[q] @ Ys[q])))
            assert np.abs(r16.betas[q] - r32.betas[q]).max() <= tol
            assert np.abs(r16.betas[q] - res_c.betas[q]).max() <= tol
        assert (r16.masks != r32.masks).sum() <= 2 * Ys.shape[0]
        assert (r16.masks != res_c.masks).sum() <= 2 * Ys.shape[0]


@pytest.mark.parametrize("c", [8, 37, 2500])
@pytest.mark.parametrize("shape", [(784, 50000), (777, 1001), (20000, 256)])
def test_update_block_passes_give_the_wide_bits(cuda, shape, c):
    """A dictionary update's added block: the fused pass (‖x_j‖² with the
    fit's zero centre, and scores) and ``screen_matvec`` launched with
    ``wide_p=p``, and the bf16 error bound, give the whole width's bits at
    the block's columns."""
    n, p = shape
    c = min(c, p // 2)
    X = _det((n, p), 21).to(cuda)
    cen = _det((n,), 22).to(cuda)
    cols = torch.from_numpy(np.sort(np.random.default_rng(c).choice(
        p, c, replace=False))).to(cuda)
    blk = X[:, cols].contiguous()
    for centre in (torch.zeros(n, device=cuda), cen):
        sc, ss = edpp_screen.edpp_screen_scores(X, centre, 0.37)
        sc_b, ss_b = edpp_screen.edpp_screen_scores(blk, centre, 0.37,
                                                    wide_p=p)
        assert torch.equal(ss_b, ss[cols]) and torch.equal(sc_b, sc[cols])
    assert torch.equal(edpp_screen.screen_matvec(blk, cen, wide_p=p),
                       edpp_screen.screen_matvec(X, cen)[cols])
    Xb = X.to(torch.bfloat16)
    assert torch.equal(ops.bf16_column_err(blk, blk.to(torch.bfloat16)),
                       ops.bf16_column_err(X, Xb)[cols])
    del X, Xb, blk
    torch.cuda.empty_cache()


def test_session_update_on_the_card_is_a_cold_fit(cuda):
    """``session.update`` on the card (a balanced edit, then a mixed one)
    with a bf16 copy and a live batch workspace: the cold fit's arrays
    bit for bit, then its masks and β bit for bit after
    ``reset_solver_cache()``; the update launches the kernels and no
    plain version."""
    from repro_torch.core import PathWorkspace
    X, Y, _ = _batch_problem(batch=8, n=100, p=2000)
    rng = np.random.default_rng(3)
    cfg = PathConfig(solve=SolveSpec(tol=1e-6))
    sess = LassoSession.fit(X, config=cfg)
    sess.geometry.screen_err(torch.bfloat16)
    ws = PathWorkspace(None, torch.as_tensor(Y, device=cuda),
                       geometry=sess.geometry)
    X_ed = X
    for drop, k in ((np.sort(rng.choice(2000, 100, replace=False)), 100),
                    (np.sort(rng.choice(2000, 16, replace=False)), 40)):
        add = rng.standard_normal((100, k)).astype(np.float32)
        ops.reset_counts()
        sess.update(add=add, drop=drop, workspaces=[ws])
        torch.cuda.synchronize()
        assert ops.launch_counts()["edpp_screen_scores"] == 1
        assert ops.launch_counts()["screen_matvec"] == 1
        assert not any(ops.plain_counts().values())
        r = min(k, drop.size)          # the layout rule: recycle, append
        Xp = X_ed.copy()
        Xp[:, drop[:r]] = add[:, :r]
        keep = np.setdiff1d(np.arange(X_ed.shape[1]), drop[r:])
        X_ed = np.concatenate([Xp[:, keep], add[:, r:]], axis=1)
        cold = LassoSession.fit(X_ed, config=cfg)
        g, cg = sess.geometry, cold.geometry
        for a, b in ((g.X, cg.X), (g.sumsq, cg.sumsq),
                     (g.col_norms, cg.col_norms),
                     (g.screen_copy(torch.bfloat16),
                      cg.screen_copy(torch.bfloat16)),
                     (g.screen_err(torch.bfloat16),
                      cg.screen_err(torch.bfloat16))):
            assert torch.equal(a, b)
        cws = PathWorkspace(None, torch.as_tensor(Y, device=cuda),
                            geometry=cg)
        assert torch.equal(ws.abs_xty, cws.abs_xty)
        assert np.array_equal(ws.istar, cws.istar)
        sess.reset_solver_cache()
        ru = sess.path(Y, num_lambdas=20)
        rc = cold.path(Y, num_lambdas=20)
        np.testing.assert_array_equal(ru.masks, rc.masks)
        np.testing.assert_array_equal(ru.betas, rc.betas)


def test_mesh_bf16_and_update_over_nccl(cuda, tmp_path):
    """World size 1 over NCCL: the mesh session's bf16 screen gives its
    float32 masks bit for bit (``screen_matvec_bf16`` launched), its bf16
    solve the unsharded bf16 solve's masks (``fista_step_bf16``
    launched), and its update the unsharded update's arrays and masks bit
    for bit."""
    X, y, _ = lasso_problem(100, 1000, nnz=10, seed=0, dtype=np.float32)
    rng = np.random.default_rng(4)

    def cfg(screen="float32", solve="float32"):
        return PathConfig(screen=ScreenSpec(screen_dtype=screen),
                          solve=SolveSpec(tol=1e-6, solve_dtype=solve))

    plain = LassoSession.fit(X)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp_path, "store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", 0))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("query", "feature"))
        sess = LassoSession.fit(X, mesh=mesh)
        out = {}
        for name, s, c in (("f32", sess, cfg()),
                           ("screen", sess, cfg(screen="bfloat16")),
                           ("solve", sess, cfg(solve="bfloat16")),
                           ("plain solve", plain, cfg(solve="bfloat16"))):
            s.reset_solver_cache()
            ops.reset_counts()
            out[name] = s.path(y, num_lambdas=20, hi_frac=0.95, config=c)
            torch.cuda.synchronize()
            key = {"screen": "screen_matvec_bf16"}.get(
                name, "fista_step_bf16" if "solve" in name else "fista_step")
            assert ops.launch_counts().get(key, 0) > 0, name
            assert not any(ops.plain_counts().values())
        np.testing.assert_array_equal(out["screen"].masks, out["f32"].masks)
        np.testing.assert_array_equal(out["solve"].masks,
                                      out["plain solve"].masks)
        drop = np.sort(rng.choice(1000, 50, replace=False))
        add = rng.standard_normal((100, 66)).astype(np.float32)
        for s in (sess, plain):
            s.geometry.screen_err(torch.bfloat16)
            s.update(add=add[:, :50], drop=drop)
            s.update(add=add[:, 50:], drop=drop[:8])
        gm, gu = sess.geometry, plain.geometry
        for a, b in ((gm.X, gu.X), (gm.sumsq, gu.sumsq),
                     (gm.screen_copy(torch.bfloat16),
                      gu.screen_copy(torch.bfloat16)),
                     (gm.screen_err(torch.bfloat16),
                      gu.screen_err(torch.bfloat16))):
            assert torch.equal(a, b)
        for s in (sess, plain):
            s.reset_solver_cache()
        np.testing.assert_array_equal(
            sess.path(y, num_lambdas=20, config=cfg()).masks,
            plain.path(y, num_lambdas=20, config=cfg()).masks)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape, m, parts", [
    ((250, 16800), 10, 4), ((250, 200000), 10, 2), ((777, 1000), 5, 2),
    ((64, 2400), 200, 3), ((100, 2376), 33, 2)])
def test_group_pass_wide_p_gives_the_full_widths_bits(cuda, shape, m, parts):
    """A mesh rank's block of whole groups: the group pass launched with
    ``wide_p`` = the whole width gives the full pass's scores bit for bit
    at the block's groups (and two launches the same bits). At
    250 × 16 800 in quarters the block's own plan splits the rows over a
    cluster where the whole width's does not."""
    n, p = shape
    X = _det((n, p), 31).to(cuda)
    c = _det((n,), 32).to(cuda)
    full = group_screen.group_screen_scores(X, c, m)
    w = p // parts
    for r in range(parts):
        blk = X[:, r * w:(r + 1) * w].contiguous()
        got = group_screen.group_screen_scores(blk, c, m, wide_p=p)
        assert torch.equal(got, full[r * w // m:(r + 1) * w // m]), r
        assert torch.equal(got, group_screen.group_screen_scores(
            blk, c, m, wide_p=p))
        _close([got], [ref.group_screen_ref(blk, c, m)])
    del X
    torch.cuda.empty_cache()


@pytest.mark.parametrize("G, m, parts", [(2000, 10, 2), (2000, 10, 4),
                                         (96, 5, 3), (40, 5, 40)])
def test_group_spectral_norms_of_blocks_are_the_full_batchs(cuda, G, m,
                                                            parts):
    """‖X_g‖₂ of a block's groups (one batched ``eigvalsh`` of G/F Grams,
    or of one) against the whole batch's at those groups, bit for bit: a
    group mesh session gathers the blocks' norms."""
    from repro_torch.core.group_screening import group_spectral_norms
    X = _det((250, G * m), 33).to(cuda)
    full = group_spectral_norms(X, m)
    w = G * m // parts
    got = torch.cat([group_spectral_norms(
        X[:, r * w:(r + 1) * w].contiguous(), m) for r in range(parts)])
    diff = int((got != full).sum())
    print(f"G={G}, m={m}, {parts} blocks: {diff} of {G} norms differ, "
          f"max |Δ| {float((got - full).abs().max()):.3g}")
    assert diff == 0


def test_one_shot_fista_launches_its_kernel_on_the_card(cuda):
    """``repro_torch.core.fista`` on a CUDA X: one ``fista_step`` launch
    per iteration, no plain version; β against the same call on the CPU
    within beta_err_tol(y, 1e-6); host arrays go to the card."""
    from repro_torch.core import cd, fista
    X, y, _ = lasso_problem(100, 1024, nnz=10, seed=1, dtype=np.float32)
    lam = 0.3 * float(np.abs(X.T @ y).max())
    ops.reset_counts()
    res = fista(torch.from_numpy(X).to(cuda), y, lam, tol=1e-6)
    torch.cuda.synchronize()
    assert res.beta.is_cuda and bool(res.converged)
    assert ops.launch_counts()["fista_step"] == res.iters > 0
    assert not any(ops.plain_counts().values())
    assert fista(X, y, lam, tol=1e-6, max_iter=20).beta.is_cuda
    cpu = cd(X, y, lam, tol=1e-6, device="cpu")
    tol = 25.0 * float(np.sqrt(1e-6 * 0.5 * float(y @ y)))
    assert float(np.abs(res.beta.cpu().numpy()
                        - cpu.beta.numpy()).max()) <= tol


def _nccl_one_rank(tmp_path):
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp_path, "store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", 0))


def test_group_mesh_session_over_nccl_matches_the_unsharded_one(cuda,
                                                                tmp_path):
    """World size 1 over NCCL: ``fit(X, groups=10, mesh=)`` runs the group
    pass on the card through ``shard:cuda`` (no plain version) and gives
    the unsharded group session's masks, stats and β bit for bit; a
    ("query", "a", "b") mesh of shape (1, 1, 1) gives the (1, 1) mesh's
    plain and group paths bit for bit."""
    X, y, _ = group_lasso_problem(100, 4000, 10, active_groups=8, seed=0,
                                  dtype=np.float32)
    cfg = PathConfig(solve=SolveSpec(tol=1e-6))
    plain = LassoSession.fit(X, groups=10, config=cfg)
    res_u = plain.path(y, num_lambdas=20, hi_frac=0.95)
    _nccl_one_rank(tmp_path)
    try:
        runs = {}
        for names in (("query", "feature"), ("query", "a", "b")):
            mesh = init_device_mesh("cuda", (1,) * len(names),
                                    mesh_dim_names=names)
            ops.reset_counts()
            sess = LassoSession.fit(X, groups=10, mesh=mesh, config=cfg)
            res = sess.path(y, num_lambdas=20, hi_frac=0.95)
            torch.cuda.synchronize()
            assert sess.backend_name == "shard:cuda"
            assert ops.launch_counts()["group_screen_scores"] > 0
            assert not any(ops.plain_counts().values())
            lasso = LassoSession.fit(X, mesh=mesh, config=cfg).path(
                y, num_lambdas=20, hi_frac=0.95)
            runs[len(names)] = (res, lasso)
        for res, _ in runs.values():
            np.testing.assert_array_equal(res.masks, res_u.masks)
            np.testing.assert_array_equal(res.betas, res_u.betas)
            assert [(s.n_discarded, s.x_passes, s.bucket)
                    for s in res.stats] == [
                (s.n_discarded, s.x_passes, s.bucket) for s in res_u.stats]
        np.testing.assert_array_equal(runs[3][1].masks, runs[2][1].masks)
        np.testing.assert_array_equal(runs[3][1].betas, runs[2][1].betas)
    finally:
        dist.destroy_process_group()
