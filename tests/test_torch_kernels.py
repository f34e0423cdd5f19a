"""The port's kernel ops on the CPU: each plain PyTorch version against the
reference's jnp oracle over SHAPES × BATCHES, and against its Pallas
kernel in interpret mode over the reference's own sweep (every shape at
one query, every batch at (60, 300)), on the same numpy inputs; the CUDA
wrappers' routing and refusals; the build command. The CUDA kernels
themselves run only on the card (``chip_smoke.py`` holds them against
these plain versions there).

Tolerance: rtol = atol = 2e-5, the reference's own float32 kernel sweep
(tests/test_kernels.py) — the sums run in another order in each package;
for the Gram CD sweep rtol = 2e-4, atol = 2e-5, the reference's own (a
rounding difference in q propagates through the sweeps' chain).
"""

import ctypes
import math
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import (build, edpp_screen, group_screen, ops, ref,
                                 solver_step)


SHAPES = [(8, 128), (60, 300), (128, 512), (100, 1000), (7, 130), (256, 131)]
BATCHES = [1, 3, 8, 17]
TOL = dict(rtol=2e-5, atol=2e-5)
CD_TOL = dict(rtol=2e-4, atol=2e-5)
REPO = Path(__file__).resolve().parents[1]


def _case(shape, batch, seed):
    """X (n, p), a (n,) query for batch 1 and a (B, n) block otherwise,
    and (p,)/(B, p) vectors, all float32 from one numpy seed."""
    n, p = shape
    rng = np.random.default_rng(seed)
    lead = () if batch == 1 else (batch,)
    X = rng.standard_normal((n, p)).astype(np.float32)
    c = rng.standard_normal(lead + (n,)).astype(np.float32)
    z = rng.standard_normal(lead + (p,)).astype(np.float32)
    b = rng.standard_normal(lead + (p,)).astype(np.float32)
    per_q = rng.uniform(0.1, 1.0, batch).astype(np.float32)
    return X, c, z, b, (float(per_q[0]) if batch == 1 else per_q)


def _interpreted(shape, batch) -> bool:
    """The reference's interpret-mode sweep (tests/test_kernels.py):
    SHAPES with one query, BATCHES at (60, 300)."""
    return batch == 1 or shape == (60, 300)


def _close(port, *refs):
    for r in refs:
        np.testing.assert_allclose(np.asarray(port, np.float32),
                                   np.asarray(r, np.float32), **TOL)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("shape", SHAPES)
def test_edpp_screen_plain_matches_reference(shape, batch):
    X, c, _, _, rho = _case(shape, batch, 1)
    s, ss = ref.edpp_screen_ref(torch.from_numpy(X), torch.from_numpy(c),
                                torch.as_tensor(rho))
    s_j, ss_j = jref.edpp_screen_ref(jnp.asarray(X), jnp.asarray(c),
                                     jnp.asarray(rho))
    assert s.shape == s_j.shape and ss.shape == (shape[1],)
    _close(s, s_j)
    _close(ss, ss_j)
    if _interpreted(shape, batch):
        s_k, ss_k = jops.edpp_screen_scores(jnp.asarray(X), jnp.asarray(c),
                                            jnp.asarray(rho), interpret=True)
        _close(s, s_k)
        _close(ss, ss_k)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("shape", SHAPES)
def test_screen_matvec_plain_matches_reference(shape, batch):
    X, c, _, _, _ = _case(shape, batch, 2)
    d = ref.screen_matvec_ref(torch.from_numpy(X), torch.from_numpy(c))
    d_j = jref.screen_matvec_ref(jnp.asarray(X), jnp.asarray(c))
    assert d.shape == d_j.shape
    _close(d, d_j)
    if _interpreted(shape, batch):
        _close(d, jops.screen_matvec(jnp.asarray(X), jnp.asarray(c),
                                     interpret=True))


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("shape", SHAPES)
def test_fista_step_plain_matches_reference(shape, batch):
    X, r, z, b, lam = _case(shape, batch, 3)
    out = ref.fista_step_ref(torch.from_numpy(X), torch.from_numpy(r),
                             torch.from_numpy(z), torch.from_numpy(b),
                             0.01, torch.as_tensor(lam), 0.6)
    args = (jnp.asarray(X), jnp.asarray(r), jnp.asarray(z), jnp.asarray(b),
            0.01, jnp.asarray(lam), 0.6)
    for o, o_j in zip(out, jref.fista_step_ref(*args)):
        assert o.shape == o_j.shape
        _close(o, o_j)
    if _interpreted(shape, batch):
        for o, o_k in zip(out, jops.fista_step(*args, interpret=True)):
            _close(o, o_k)


@pytest.mark.parametrize("batch", [1, 3])
def test_fista_step_plain_float64(batch):
    """float64 stays float64 (``_acc_dtype``); held against numpy in
    float64 to rounding."""
    X, r, z, b, lam = (np.asarray(a, np.float64)
                       for a in _case((60, 300), batch, 4))
    beta, znew = ref.fista_step_ref(*(torch.from_numpy(a)
                                      for a in (X, r, z, b)),
                                    0.01, torch.as_tensor(lam), 0.6)
    assert beta.dtype == znew.dtype == torch.float64
    g = r @ X
    lam_c = lam[:, None] if batch > 1 else lam
    u = z - 0.01 * g
    want = np.sign(u) * np.maximum(np.abs(u) - 0.01 * lam_c, 0.0)
    np.testing.assert_allclose(beta.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(znew.numpy(), want + 0.6 * (want - b),
                               rtol=1e-12, atol=1e-12)


def _gram_case(b, seed, batch=1):
    """The reference's Gram CD case: G = AᵀA with three zero (padded)
    columns, c, a small warm start and λ = ½·max|c| (per query)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((2 * b, b)).astype(np.float32)
    A[:, -3:] = 0.0
    G = A.T @ A
    if batch == 1:
        c = A.T @ rng.standard_normal(2 * b).astype(np.float32)
        beta0 = rng.standard_normal(b).astype(np.float32) * 0.1
        return G, c, beta0, 0.5 * float(np.abs(c).max()), None
    c = rng.standard_normal((batch, b)).astype(np.float32)
    beta0 = (rng.standard_normal((batch, b)) * 0.1).astype(np.float32)
    valid = (rng.uniform(size=(batch, b)) > 0.3).astype(np.float32)
    lam = rng.uniform(0.5, 2.0, batch).astype(np.float32)
    return G, c, beta0 * valid, lam, valid


@pytest.mark.parametrize("b", [17, 64, 130, 512])
def test_cd_gram_sweep_plain_matches_reference(b):
    """The reference's sweep (tests/test_kernels.py): 3 sweeps, three
    zero-Gram columns that must stay at 0."""
    G, c, beta0, lam, _ = _gram_case(b, b)
    out = solver_step.cd_gram_sweep(*map(torch.from_numpy, (G, c, beta0)),
                                    lam, sweeps=3)
    args = (jnp.asarray(G), jnp.asarray(c), jnp.asarray(beta0), lam)
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jref.cd_gram_sweep_ref(*args, sweeps=3)), **CD_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jops.cd_gram_sweep(*args, sweeps=3, interpret=True)), **CD_TOL)
    assert not out[-3:].any()


@pytest.mark.parametrize("batch", [2, 9])
def test_cd_gram_sweep_plain_batched_with_valid(batch):
    """Batched with per-query λ and ``valid``: screened-out and zero-Gram
    columns stay at 0 (the reference's batched sweep)."""
    G, c, beta0, lam, valid = _gram_case(48, 40 + batch, batch)
    out = solver_step.cd_gram_sweep(*map(torch.from_numpy, (G, c, beta0)),
                                    torch.from_numpy(lam), sweeps=2,
                                    valid=torch.from_numpy(valid))
    args = (jnp.asarray(G), jnp.asarray(c), jnp.asarray(beta0),
            jnp.asarray(lam))
    assert out.shape == (batch, 48)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref.cd_gram_sweep_ref(
        *args, sweeps=2, valid=jnp.asarray(valid))), **CD_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jops.cd_gram_sweep(
        *args, sweeps=2, valid=jnp.asarray(valid), interpret=True)), **CD_TOL)
    assert not (out.numpy() * (1 - valid)).any()
    assert not out[:, -3:].any()


def test_cd_gram_sweep_rejects_oversized():
    b = solver_step.GRAM_BUCKET_MAX + 1
    with pytest.raises(ValueError, match="GRAM_BUCKET_MAX"):
        solver_step.cd_gram_sweep(torch.zeros(b, b), torch.zeros(b),
                                  torch.zeros(b), 0.1)
    assert ops.GRAM_BUCKET_MAX == jops.GRAM_BUCKET_MAX == 1024


@pytest.mark.parametrize("m", [2, 5, 10])
@pytest.mark.parametrize("shape", [(60, 300), (100, 1000)])
def test_group_screen_plain_matches_reference(shape, m):
    """The reference's group sweep: the plain version against its jnp
    oracle and the Pallas kernel in interpret mode."""
    n, p = shape
    rng = np.random.default_rng(2)
    X = rng.standard_normal((n, p)).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    gs = group_screen.group_screen_scores(torch.from_numpy(X),
                                          torch.from_numpy(c), m)
    assert gs.shape == (p // m,)
    _close(gs, jref.group_screen_ref(jnp.asarray(X), jnp.asarray(c), m),
           jops.group_screen_scores(jnp.asarray(X), jnp.asarray(c), m,
                                    interpret=True))


def test_group_screen_refuses_a_group_size_that_does_not_divide_p():
    with pytest.raises(ValueError, match="must divide p"):
        group_screen.group_screen_scores(torch.zeros(4, 10), torch.zeros(4),
                                         3)


@pytest.mark.parametrize("batch", [1, 3])
def test_zero_padding_is_an_exact_no_op(batch):
    """Zero rows and zero columns are no-ops: padded columns come out
    exactly 0 (score 0, β = z' = 0) and the real ones agree to the sweep's
    tolerance (BLAS may sum a wider matrix in another order)."""
    X, c, z, b, lam = _case((60, 300), batch, 5)
    Xp = np.zeros((64, 320), np.float32)
    Xp[:60, :300] = X
    lead = c.shape[:-1]
    cp = np.zeros(lead + (64,), np.float32)
    cp[..., :60] = c
    zp = np.zeros(lead + (320,), np.float32)
    zp[..., :300] = z
    bp = np.zeros(lead + (320,), np.float32)
    bp[..., :300] = b
    t = torch.from_numpy
    s, ss = ref.edpp_screen_ref(t(X), t(c), 0.3)
    s_p, ss_p = ref.edpp_screen_ref(t(Xp), t(cp), 0.3)
    _close(s_p[..., :300], s)
    _close(ss_p[:300], ss)
    assert not s_p[..., 300:].any() and not ss_p[300:].any()
    d_p = ref.screen_matvec_ref(t(Xp), t(cp))
    _close(d_p[..., :300], ref.screen_matvec_ref(t(X), t(c)))
    assert not d_p[..., 300:].any()
    bn, zn = ref.fista_step_ref(t(X), t(c), t(z), t(b), 0.01,
                                torch.as_tensor(lam), 0.6)
    bn_p, zn_p = ref.fista_step_ref(t(Xp), t(cp), t(zp), t(bp), 0.01,
                                    torch.as_tensor(lam), 0.6)
    _close(bn_p[..., :300], bn)
    _close(zn_p[..., :300], zn)
    assert not bn_p[..., 300:].any() and not zn_p[..., 300:].any()


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    X, c, z, b = (torch.from_numpy(a) for a in _case((60, 300), 3, 6)[:4])
    G = X.T @ X
    ops.reset_counts()
    s, ss = edpp_screen.edpp_screen_scores(X, c, 0.5)
    d = edpp_screen.screen_matvec(X, c)
    bn, zn = solver_step.fista_step(X, c, z, b, 0.01, 0.5, 0.6)
    gs = group_screen.group_screen_scores(X, c[0], 5)
    cd = solver_step.cd_gram_sweep(G, z, b, 0.5, sweeps=1)
    pb, pz = solver_step.prox_step(z, b, z, 0.01, 0.5, 0.6)
    assert ops.launch_counts() == dict.fromkeys(ops.OPS, 0)
    assert ops.plain_counts() == dict.fromkeys(ops.OPS, 1)
    assert len(ops.OPS) == 6
    assert torch.equal(d, ref.screen_matvec_ref(X, c))
    assert torch.equal(s, ref.edpp_screen_ref(X, c, 0.5)[0])
    assert torch.equal(bn, ref.fista_step_ref(X, c, z, b, 0.01, 0.5, 0.6)[0])
    assert torch.equal(gs, ref.group_screen_ref(X, c[0], 5))
    assert torch.equal(cd, ref.cd_gram_sweep_ref(G, z, b, 0.5, sweeps=1))
    want = ref.prox_step_ref(z, b, z, 0.01, 0.5, 0.6)
    assert torch.equal(pb, want[0]) and torch.equal(pz, want[1])


def test_per_query_parameters_never_copy_host_numbers():
    """Host numbers pass by value; beside a device tensor they are filled
    on the tensor's device (no host-to-device copy, so no sync)."""
    assert edpp_screen.params(3, "cpu", 0.5, 2, 0.25) == (None,
                                                         (0.5, 2.0, 0.25))
    par, scal = edpp_screen.params(3, "cpu", 0.5, torch.tensor([1., 2., 3.]),
                                   torch.tensor(0.25))
    assert scal == (0.0, 0.0, 0.0) and par.dtype == torch.float32
    assert torch.equal(par, torch.tensor([[0.5] * 3, [1., 2., 3.],
                                          [0.25] * 3]))
    sl, ptr = edpp_screen.chunk_ptr(par, 1, 2)
    assert sl.is_contiguous() and ptr == sl.data_ptr()
    assert torch.equal(sl, par[:, 1:3])


def test_backend_follows_the_device():
    assert ops.resolve_backend(None, "cpu").name == "torch"
    assert ops.resolve_backend(None, "cuda").name == "cuda"
    assert ops.resolve_backend("cuda", "cpu").fista_step \
        is solver_step.fista_step
    cuda = ops.resolve_backend("cuda", "cpu")
    assert cuda.group_scores is group_screen.group_screen_scores
    assert cuda.cd_gram_sweep is solver_step.cd_gram_sweep
    assert cuda.prox_step is solver_step.prox_step
    plain = ops.resolve_backend("torch", "cpu")
    assert (plain.group_scores, plain.cd_gram_sweep, plain.prox_step) \
        == (ref.group_screen_ref, ref.cd_gram_sweep_ref, ref.prox_step_ref)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.resolve_backend("pallas", "cpu")


class _CudaLike:
    """Stands in for a CUDA tensor on a machine without one: the wrappers
    only read device, dtype, shape and contiguity before they launch."""

    def __init__(self, *shape, dtype=torch.float32, contiguous=True):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device("cuda", 0)
        self.contiguous = contiguous

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self.contiguous

    def unsqueeze(self, dim):
        assert dim == 0
        return _CudaLike(1, *self.shape, dtype=self.dtype,
                         contiguous=self.contiguous)


@pytest.fixture
def no_toolkit(monkeypatch, tmp_path):
    """No built library and no nvcc."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))


def test_cuda_tensors_launch_or_raise_never_the_plain_version(no_toolkit):
    X, c = _CudaLike(60, 300), _CudaLike(60)
    z, b = _CudaLike(300), _CudaLike(300)
    ops.reset_counts()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        edpp_screen.edpp_screen_scores(X, c, 0.5)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        edpp_screen.screen_matvec(X, c)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        solver_step.fista_step(X, c, z, b, 0.01, 0.5, 0.6)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        group_screen.group_screen_scores(X, c, 5)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        solver_step.cd_gram_sweep(_CudaLike(64, 64), _CudaLike(64),
                                  _CudaLike(64), 0.5, sweeps=2)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        solver_step.prox_step(z, z, b, 0.01, 0.5, 0.6)
    assert sum(ops.plain_counts().values()) == 0
    assert sum(ops.launch_counts().values()) == 0


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(no_toolkit):
    X = _CudaLike(60, 300)
    with pytest.raises(TypeError, match="float32"):
        edpp_screen.screen_matvec(_CudaLike(60, 300, dtype=torch.float64),
                                  _CudaLike(60))
    with pytest.raises(ValueError, match=r"\(60,\) or \(B, 60\)"):
        edpp_screen.screen_matvec(X, _CudaLike(61))
    with pytest.raises(ValueError, match="is on cpu"):
        edpp_screen.edpp_screen_scores(X, torch.zeros(60), 0.0)
    with pytest.raises(ValueError, match="disagree on B"):
        solver_step.fista_step(X, _CudaLike(2, 60), _CudaLike(3, 300),
                               _CudaLike(3, 300), 0.1, 0.1, 0.1)
    # the group pass: p % m, a batched centre, a non-contiguous X
    with pytest.raises(ValueError, match="must divide p"):
        group_screen.group_screen_scores(X, _CudaLike(60), 7)
    with pytest.raises(ValueError, match="rank 1"):
        group_screen.group_screen_scores(X, _CudaLike(2, 60), 5)
    with pytest.raises(ValueError, match="contiguous"):
        group_screen.group_screen_scores(
            _CudaLike(60, 300, contiguous=False), _CudaLike(60), 5)
    # the Gram sweep: p > GRAM_BUCKET_MAX, a non-square or non-contiguous
    # G, a non-contiguous β, c and valid that disagree with β on B
    big = solver_step.GRAM_BUCKET_MAX + 1
    with pytest.raises(ValueError, match="GRAM_BUCKET_MAX"):
        solver_step.cd_gram_sweep(_CudaLike(big, big), _CudaLike(big),
                                  _CudaLike(big), 0.1)
    G, v = _CudaLike(64, 64), _CudaLike(64)
    with pytest.raises(ValueError, match="square"):
        solver_step.cd_gram_sweep(_CudaLike(64, 63), v, v, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        solver_step.cd_gram_sweep(_CudaLike(64, 64, contiguous=False), v, v,
                                  0.1)
    with pytest.raises(ValueError, match="beta must be contiguous"):
        solver_step.cd_gram_sweep(G, v, _CudaLike(64, contiguous=False), 0.1)
    with pytest.raises(ValueError, match="disagree on B"):
        solver_step.cd_gram_sweep(G, _CudaLike(2, 64), _CudaLike(3, 64), 0.1)
    with pytest.raises(ValueError, match="disagree on B"):
        solver_step.cd_gram_sweep(G, _CudaLike(3, 64), _CudaLike(3, 64), 0.1,
                                  valid=_CudaLike(64))
    with pytest.raises(TypeError, match="float32"):
        solver_step.cd_gram_sweep(_CudaLike(64, 64, dtype=torch.float64), v,
                                  v, 0.1)
    # the prox step: z, g and beta_old of one (p,) or (B, p) shape,
    # float32, contiguous, on z's device
    z = _CudaLike(3, 64)
    with pytest.raises(ValueError, match="share one"):
        solver_step.prox_step(z, _CudaLike(2, 64), z, 0.1, 0.1, 0.1)
    with pytest.raises(ValueError, match="share one"):
        solver_step.prox_step(_CudaLike(1, 3, 64), _CudaLike(1, 3, 64),
                            _CudaLike(1, 3, 64), 0.1, 0.1, 0.1)
    with pytest.raises(TypeError, match="float32"):
        solver_step.prox_step(z, _CudaLike(3, 64, dtype=torch.float64), z,
                            0.1, 0.1, 0.1)
    with pytest.raises(ValueError, match="beta_old must be contiguous"):
        solver_step.prox_step(z, z, _CudaLike(3, 64, contiguous=False), 0.1,
                            0.1, 0.1)
    with pytest.raises(ValueError, match="is on cpu"):
        solver_step.prox_step(z, torch.zeros(3, 64), z, 0.1, 0.1, 0.1)


def test_kernel_entry_points_get_their_c_signature(monkeypatch):
    """Every pointer and the stream cross as c_void_p, the parameters as
    c_float: without declared argtypes ctypes cannot pass a float and
    would cut a pointer to 32 bits."""
    libc = ctypes.CDLL(None)          # a fresh handle: fresh function objects
    fns = {sym: getattr(libc, name) for sym, name in (
        ("edpp_screen_scores_f32", "labs"), ("screen_matvec_f32", "abs"),
        ("fista_step_f32", "llabs"), ("cd_gram_sweep_f32", "atoi"),
        ("group_screen_scores_f32", "atol"), ("prox_step_f32", "atoll"))}
    monkeypatch.setattr(build, "load",
                        lambda source: types.SimpleNamespace(**fns))
    for source, sym in (("edpp_screen", "edpp_screen_scores_f32"),
                        ("edpp_screen", "screen_matvec_f32"),
                        ("solver_step", "fista_step_f32"),
                        ("cd_gram", "cd_gram_sweep_f32"),
                        ("group_screen", "group_screen_scores_f32"),
                        ("prox_step", "prox_step_f32")):
        fn = edpp_screen.kernel_fn(source, sym)
        assert fn is fns[sym] and fn.restype is ctypes.c_int
        assert fn.argtypes[0] is ctypes.c_void_p
        assert fn.argtypes[-1] is ctypes.c_void_p          # the stream
        if sym not in ("screen_matvec_f32", "group_screen_scores_f32"):
            assert ctypes.c_float in fn.argtypes
    # the column passes take the launch plan's four ints after B (the
    # group pass: after m)
    for sym, at in (("edpp_screen_scores_f32", 5), ("screen_matvec_f32", 5),
                    ("fista_step_f32", 7), ("group_screen_scores_f32", 5)):
        assert fns[sym].argtypes[at - 1:at + 4] == [ctypes.c_int] * 5
    # the prox step takes its count of gradient parts after g
    assert fns["prox_step_f32"].argtypes[2] is ctypes.c_int
    n_args = {s: len(f.argtypes) for s, f in fns.items()}
    assert n_args == {"edpp_screen_scores_f32": 14, "screen_matvec_f32": 11,
                      "fista_step_f32": 18, "cd_gram_sweep_f32": 11,
                      "group_screen_scores_f32": 11, "prox_step_f32": 13}


def test_build_command_targets_sm90a_into_the_ignored_directory():
    cmd = build.nvcc_command("edpp_screen", build.library_path("edpp_screen"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    out = Path(cmd[cmd.index("-o") + 1])
    assert out.parent == build.BUILD_DIR
    assert cmd[-1] == str(build.CSRC / "edpp_screen.cu")
    rel = build.BUILD_DIR.relative_to(REPO).as_posix() + "/"
    assert rel in (REPO / ".gitignore").read_text().splitlines()
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()


@pytest.mark.parametrize("source", ["cd_gram", "group_screen", "prox_step"])
def test_new_kernel_sources_build_for_sm90a(source):
    """The Gram sweep and the group pass build like the others: their own
    library, for sm_90a, into the ignored build directory."""
    assert source in build.SOURCES
    out = build.library_path(source)
    cmd = build.nvcc_command(source, out)
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert Path(cmd[cmd.index("-o") + 1]) == out
    assert out.parent == build.BUILD_DIR and source in out.name
    assert cmd[-1] == str(build.CSRC / f"{source}.cu")


# The column pass's launch plan (``edpp_screen.launch_plan``): the paper's
# wide screens, the solver's narrow buckets, ragged and tiny shapes, a
# centre above the staging budget, on the H100's 132 SMs and a small card.
PLAN_CASES = [(784, 50000, 1), (784, 50000, 8), (3072, 99288, 1),
              (3072, 99288, 8), (784, 32, 1), (784, 32, 8), (784, 512, 1),
              (784, 4096, 8), (777, 1001, 3), (20000, 256, 8),
              (40000, 256, 8), (3072, 4096, 8), (100, 1000, 1), (7, 130, 5),
              (100, 20, 2), (0, 5, 1), (1, 1, 1)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("n, p, B", PLAN_CASES)
def test_launch_plan_covers_every_column_and_row_once(n, p, B, sms, aligned):
    """The kernel's own indexing (csrc/colpass.cuh), replayed: every column
    of X falls to one lane of each row group of one tile, every row to one
    thread of one CTA of the cluster; shared memory, cluster and staged
    centre stay within the card's limits; float4 only where p % 4 == 0
    and X is aligned; the layout does not depend on B or the alignment."""
    pl = edpp_screen.launch_plan(n, p, B, sms, aligned)
    lpr = pl.tile // 4                     # lanes on one row
    rpw = 32 // lpr                        # rows per warp step
    tiles, split = pl.grid
    assert pl.tile in (edpp_screen.WIDE_TILE, edpp_screen.NARROW_TILE)
    assert tiles == -(-p // pl.tile) and split == pl.split
    lanes = np.arange(32)
    cols = np.zeros(tiles * pl.tile, int)
    for t in range(tiles):
        first = t * pl.tile + 4 * (lanes % lpr)
        np.add.at(cols, (first[:, None] + np.arange(4)).ravel(), 1)
    assert (cols[:p] == rpw).all()         # once per row group of a warp
    # rank k of a column tile's cluster takes rows [n*k/split, n*(k+1)/split)
    ranges = [(n * k // split, n * (k + 1) // split) for k in range(split)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    stride = edpp_screen.WARPS * rpw
    for r0, r1 in ranges:
        seen = np.zeros(r1 - r0, int)
        for s0 in range(r0, max(r1, r0 + 1), pl.stage_rows):
            rows = min(pl.stage_rows, r1 - s0)
            for off in range(stride):      # warp * rpw + lane // lpr
                seen[s0 - r0 + off:s0 - r0 + rows:stride] += 1
        assert (seen == 1).all()
        if r1 - r0 > pl.stage_rows:        # stages keep each thread's rows
            assert pl.stage_rows % 32 == 0
    assert 4 * B * pl.stage_rows <= edpp_screen.CENTRE_BUDGET
    centre = -(-B * pl.stage_rows // 4) * 4
    red = edpp_screen.WARPS * (B + 1) * pl.tile
    inbox = (B + 1) * pl.tile             # the cluster's sums
    assert pl.smem == 4 * (max(centre, red) if pl.split == 1
                           else centre + red + inbox) <= edpp_screen.SMEM_MAX
    assert 1 <= pl.split <= 8 and pl.split & (pl.split - 1) == 0
    assert pl.block == 256
    assert pl.vec == (4 if aligned and p % 4 == 0 else 1)
    other = edpp_screen.launch_plan(n, p, 1, sms, not aligned)
    assert (other.tile, other.split) == (pl.tile, pl.split)


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("n, p", [(784, 50000), (3072, 99288)])
def test_wide_screen_plan_fills_whole_waves(n, p, B):
    """The wide screens take 128-column tiles read as float4, no cluster,
    and a grid whose CTAs spread over the 132 SMs to within 5 % of even."""
    pl = edpp_screen.launch_plan(n, p, B, 132, True)
    assert (pl.vec, pl.tile, pl.split, pl.stage_rows) == (4, 128, 1, n)
    ctas = pl.grid[0] * pl.grid[1]
    assert ctas >= 132 and ctas / (132 * -(-ctas // 132)) >= 0.95


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("p, split", [(32, 4), (512, 4), (4096, 2)])
def test_narrow_bucket_plan_splits_rows_over_a_cluster(p, split, B):
    """The solver's buckets (784 rows) take 32-column tiles with the rows
    split over a cluster (of at most ``CLUSTER`` CTAs) until about two
    CTAs run on each SM; a cluster of 4 at 32 columns stages 196 rows of
    r per CTA, one of 8 98 rows."""
    pl = edpp_screen.launch_plan(784, p, B, 132, True)
    assert (pl.tile, pl.split) == (32, split)
    assert pl.stage_rows == -(-784 // split)
    assert edpp_screen.launch_plan(784, p, B, 132, True,
                                   max_split=1).split == 1
    if p < 4096:
        eight = edpp_screen.launch_plan(784, p, B, 132, True, max_split=8)
        assert (eight.split, eight.stage_rows) == (8, 98)


def test_launch_plan_refuses_what_no_launch_takes():
    for args in ((784, 0, 1), (784, 32, 0), (784, 32, 9), (-1, 32, 1)):
        with pytest.raises(ValueError, match="no plan"):
            edpp_screen.launch_plan(*args, 132, True)
    with pytest.raises(ValueError, match="no plan"):
        edpp_screen.launch_plan(784, 32, 1, 132, True, max_split=16)


# The group pass's launch plan (``group_screen.group_plan``): the paper's
# group design at m = 5, 10, 20 and a group wider than a tile (m = 200),
# ragged and tiny shapes, p % 4 != 0, group sizes whose lcm with 4 exceeds
# a tile (m = 33), groups of 1 and of the whole row, on 132 SMs and 8.
GROUP_PLAN_CASES = [(250, 200000, 10), (250, 200000, 5), (250, 200000, 20),
                    (250, 200000, 200), (777, 1000, 5), (777, 1001, 7),
                    (60, 330, 33), (40, 2200, 1100), (7, 130, 1),
                    (100, 1000, 10), (60, 300, 2), (250, 20000, 20),
                    (784, 96, 3), (3, 36, 36), (0, 20, 5), (50, 129, 129)]


def _group_layout(pl, p, m):
    """The kernel's own indexing (csrc/colpass.cuh, MODE GROUP), replayed:
    the columns each tile's lanes read per step, the groups each thread
    of each cluster rank sums, and the score each writes."""
    cols = np.zeros(p, int)
    written = np.zeros(p // m, int)
    tiles, split = pl.grid
    share = pl.tile // split
    for t in range(tiles):
        col0 = t * pl.tile
        lim = min(p, col0 + pl.tile)
        for cs in range(0, pl.tile, 128):              # column steps
            first = col0 + cs + 4 * np.arange(32)
            c = (first[:, None] + np.arange(4)).ravel()
            np.add.at(cols, c[c < lim], 1)
        for rank in range(split):
            c_lo = col0 + rank * share
            for g in range(share // m):
                if c_lo + g * m < p:
                    assert c_lo + g * m + m <= min(lim, c_lo + share)
                    written[(c_lo + g * m) // m] += 1
    return cols, written


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("n, p, m", GROUP_PLAN_CASES)
def test_group_plan_keeps_whole_groups_in_one_cta(n, p, m, sms, aligned):
    """Every tile holds whole groups (tile % m == 0): at most 128 columns,
    or one group walked in steps of 128; float4 only where the tile, p and
    X allow it; every column read once a row by one lane, every group's
    score written once by the rank that owns all its columns; the rows
    of a cluster split as in the column pass; tile and cluster do not
    depend on the alignment."""
    pl = group_screen.group_plan(n, p, m, sms, aligned)
    assert pl.tile % m == 0 and (pl.tile <= 128 or pl.tile == m)
    if math.lcm(m, 4) <= 128:
        assert pl.tile == 128 // math.lcm(m, 4) * math.lcm(m, 4)
    elif m <= 128:
        assert pl.tile == 128 // m * m and pl.vec == 1
    assert pl.vec == 1 or (pl.tile % 4 == 0 and p % 4 == 0 and aligned)
    if aligned and p % 4 == 0 and pl.tile % 4 == 0:
        assert pl.vec == 4
    cols, written = _group_layout(pl, p, m)
    assert (cols == 1).all() and (written == 1).all()
    tiles, split = pl.grid
    assert tiles == -(-p // pl.tile) and split == pl.split
    assert 1 <= split <= 8 and split & (split - 1) == 0
    assert pl.tile % split == 0 and pl.tile // split % m == 0
    assert split == 1 or pl.tile <= 128
    ranges = [(n * k // split, n * (k + 1) // split) for k in range(split)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert pl.stage_rows >= -(-n // split) or pl.stage_rows % 32 == 0
    assert 4 * pl.stage_rows <= edpp_screen.CENTRE_BUDGET
    centre = -(-pl.stage_rows // 4) * 4
    red = edpp_screen.WARPS * 2 * group_screen.GROUP_SPAN
    assert pl.smem == 4 * (max(centre, red) if split == 1
                           else centre + red + 2 * pl.tile)
    assert pl.smem <= edpp_screen.SMEM_MAX and pl.block == 256
    other = group_screen.group_plan(n, p, m, sms, not aligned)
    assert (other.tile, other.split) == (pl.tile, pl.split)


@pytest.mark.parametrize("m, tile, vec, steps", [(5, 120, 4, 1),
                                                 (10, 120, 4, 1),
                                                 (20, 120, 4, 1),
                                                 (200, 200, 4, 2)])
def test_group_plan_at_the_paper_design(m, tile, vec, steps):
    """250 × 200 000 on the H100: tiles of 120 columns read as float4, no
    cluster; m = 200 walks one group a tile in two steps."""
    pl = group_screen.group_plan(250, 200000, m, 132, True)
    assert (pl.tile, pl.vec, pl.split, pl.stage_rows) == (tile, vec, 1, 250)
    assert -(-pl.tile // group_screen.GROUP_SPAN) == steps
    assert pl.grid == (-(-200000 // tile), 1)


def test_group_plan_fallbacks_and_refusals():
    """lcm(m, 4) > 128: m = 33 takes three groups a tile with scalar
    loads, m = 200 one group a tile; a cluster never cuts a group: at
    777 × 1 001, m = 7, each of 4 ranks owns 28 columns, 4 groups; and
    m = 20 at 120 columns takes 2 ranks, not 4 (30 columns would cut a
    group). No plan where m does not divide p."""
    assert group_screen.group_plan(60, 330, 33, 132, True)[:3] == (1, 99, 1)
    assert group_screen.group_plan(250, 2000, 200, 132, True)[:3] == (4, 200,
                                                                      1)
    assert group_screen.group_plan(250, 2200, 1100, 132, True)[:2] == (4,
                                                                       1100)
    assert group_screen.group_plan(777, 1001, 7, 132, True)[:3] == (1, 112, 4)
    assert group_screen.group_plan(784, 240, 20, 132, True)[1:3] == (120, 2)
    for args in ((250, 1000, 3), (250, 0, 5), (250, 1000, 0), (-1, 10, 5)):
        with pytest.raises(ValueError, match="no plan"):
            group_screen.group_plan(*args, 132, True)


def _cd_chunked(G, c, beta, lam, sweeps, valid=None, chunk=32):
    """The Gram sweep as csrc/cd_gram.cu schedules it, in torch: q0 as the
    plain version takes it; the coordinates in chunks of 32; inside a
    chunk each step's delta is added at once to the q of the chunk's own
    coordinates (the owning warp's lanes), and to every other q only at
    the chunk's end, in coordinate order, from G's row j (G is
    symmetric); the update rounded as the kernel rounds it (every lane
    divides, a zero magnitude by way of the dividend 1, and the quotient
    is signed after the division)."""
    p = G.shape[0]
    beta = beta.clone()
    batched = beta.dim() == 2
    lam_t = (torch.as_tensor(lam, dtype=beta.dtype).broadcast_to(
        (beta.shape[0],)) if batched else torch.as_tensor(lam,
                                                          dtype=beta.dtype))
    q = beta @ G if batched else G @ beta
    for _ in range(sweeps):
        for lo in range(0, p, chunk):
            hi = min(p, lo + chunk)
            rest = torch.cat([torch.arange(0, lo), torch.arange(hi, p)])
            deltas = []
            for j in range(lo, hi):
                gjj, bj = G[j, j], beta[..., j]
                rho = (c[..., j] - q[..., j]) + gjj * bj
                mag = torch.clamp(torch.abs(rho) - lam_t, min=0.0)
                den = torch.clamp(gjj, min=1e-30) if gjj > 0 else \
                    torch.ones_like(gjj)
                div = torch.where(mag > 0, mag, torch.ones_like(mag)) / den
                quo = torch.where(mag > 0, div, torch.zeros_like(mag))
                bn = torch.where(gjj > 0, torch.where(rho < 0, -quo, quo),
                                 torch.zeros_like(quo))
                if valid is not None:
                    bn = bn * valid[..., j]
                delta = bn - bj
                d = delta[:, None] if batched else delta
                q[..., lo:hi] = q[..., lo:hi] + G[j, lo:hi] * d
                beta[..., j] = bn
                deltas.append(d)
            for j, d in zip(range(lo, hi), deltas):
                q[..., rest] = q[..., rest] + G[j, rest] * d
    return beta


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("p", [32, 96, 1000])
def test_cd_chunked_schedule_equals_the_plain_sweep(p, masked):
    """The kernel's schedule (chunks of 32, deltas to the other
    coordinates deferred to the chunk's end and added in coordinate
    order) gives the plain version's bits: every q_k sees the same
    operations in the same order. One query at p = 32, three with
    per-query λ above it; three zero-Gram (padded) columns."""
    batch = 1 if p == 32 else 3
    rng = np.random.default_rng(p + masked)
    A = rng.standard_normal((2 * p, p)).astype(np.float32)
    A[:, -3:] = 0.0
    G = torch.from_numpy(A.T @ A)
    G = 0.5 * (G + G.T)
    lead = () if batch == 1 else (batch,)
    c = torch.from_numpy(rng.standard_normal(lead + (p,)).astype(
        np.float32)) @ G * 0.1
    beta = torch.from_numpy((0.1 * rng.standard_normal(lead + (p,))).astype(
        np.float32))
    valid = None
    if masked:
        valid = torch.from_numpy((rng.uniform(size=lead + (p,)) > 0.3).astype(
            np.float32))
        beta = beta * valid
    lam = (0.5 * c.abs().amax(-1) if batch > 1
           else 0.5 * float(c.abs().max()))
    sweeps = 3 if p < 1000 else 1
    want = ref.cd_gram_sweep_ref(G, c, beta, lam, sweeps, valid)
    got = _cd_chunked(G, c, beta, lam, sweeps, valid)
    assert torch.equal(got, want)
    assert (want != beta).any() and not want[..., -3:].any()
