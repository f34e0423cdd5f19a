"""The recurrent mixers (``repro_torch.models.ssm``) against the reference's
(``repro.models.ssm``) on the CPU, on the same numpy-seeded inputs and
the reference's parameters:

* ``ssd_chunked``: a sequence that is not a multiple of the chunk (200
  at chunk 128, the last chunk padded), with and without a carried
  ``h0``, f32 and bf16 values; its gradients against ``jax.grad``;
  ``ssd_decode_step``; ``causal_conv1d`` with and without a state;
* Mamba2, mLSTM and sLSTM forward (several chunks, the last one partial)
  and one decode step from the state the reference's forward leaves, in
  f32 and in bf16 on the train step's cast (every f32 parameter with
  ndim > 1 to bf16): outputs and states;
* each mixer's gradients in bf16 (the train step's cast): bf16 values
  for the bf16 leaves, and each leaf no further from the reference's f32
  gradient than twice the reference's own bf16 gradient is;
* mLSTM's stabiliser is detached, as the reference's ``stop_gradient``.

Tolerances: f32 to rtol 1e-5 of the output's scale; bf16 to 2e-2 (bf16
keeps 8 bits, and a mixer rounds several times).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import ssm as JS
from repro_torch import configs as TC
from repro_torch.models import ssm as TS
from torch_lm_util import close_to

F32_TOL = 1e-5
BF16_TOL = 2e-2
DTYPES = ["float32", "bfloat16"]


def _jd(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _td(dtype):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def _tol(dtype):
    return BF16_TOL if dtype == "bfloat16" else F32_TOL


def _pair(a, dtype):
    return (jnp.asarray(a, _jd(dtype)),
            torch.from_numpy(np.asarray(a, np.float32)).to(_td(dtype)))


def _t(a):
    """A jax array (or a tuple of them) as torch tensors of its dtype."""
    if isinstance(a, (tuple, list)):
        return type(a)(_t(x) for x in a)
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _params(init, spec, seed: int, dtype: str):
    """The reference's mixer parameters in both packages, cast as the
    train step casts them for ``dtype``."""
    jp, _ = init(jax.random.PRNGKey(seed), spec)
    if dtype == "bfloat16":
        jp = jax.tree.map(lambda v: v.astype(jnp.bfloat16)
                          if v.dtype == jnp.float32 and v.ndim > 1 else v, jp)
    return jp, {k: _t(v) for k, v in jp.items()}


def _spec(arch: str, kind: str, **kw):
    """The tiny config's spec of ``kind`` (``mamba``, ``mlstm``,
    ``slstm``), with ``kw`` replaced; the same dataclass fields build the
    reference's."""
    cfg = TC.get_tiny(arch)
    blk = next(b for seg in cfg.segments for b in seg.blocks
               if getattr(b, kind) is not None)
    tspec = dataclasses.replace(getattr(blk, kind), **kw)
    jcls = getattr(JS, type(tspec).__name__)
    return jcls(**dataclasses.asdict(tspec)), tspec


# ---------------------------------------------------------------------------
# the core
# ---------------------------------------------------------------------------

def _ssd_inputs(b, s, h, n, pv, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, s, h, pv)).astype(np.float32)
    k = rng.standard_normal((b, s, h, n)).astype(np.float32) / np.sqrt(n)
    q = rng.standard_normal((b, s, h, n)).astype(np.float32)
    ld = -rng.uniform(0.0, 0.3, (b, s, h)).astype(np.float32)
    h0 = rng.standard_normal((b, h, n, pv)).astype(np.float32)
    return v, k, q, ld, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_chunked_matches_reference(dtype, with_h0):
    """200 steps at chunk 128: a full chunk and a padded one."""
    v, k, q, ld, h0 = _ssd_inputs(2, 200, 3, 8, 5, seed=1)
    jv, tv = _pair(v, dtype)
    jh0, th0 = (jnp.asarray(h0), torch.from_numpy(h0)) if with_h0 else \
        (None, None)
    jy, jh = JS.ssd_chunked(jv, jnp.asarray(k), jnp.asarray(q),
                            jnp.asarray(ld), chunk=128, h0=jh0)
    ty, th = TS.ssd_chunked(tv, torch.from_numpy(k), torch.from_numpy(q),
                            torch.from_numpy(ld), chunk=128, h0=th0)
    assert ty.dtype == _td(dtype) and th.dtype == torch.float32
    assert ty.shape == (2, 200, 3, 5) and th.shape == (2, 3, 8, 5)
    close_to(ty, jy, _tol(dtype))
    close_to(th, jh, F32_TOL)


def test_ssd_chunked_gradients_match_reference():
    v, k, q, ld, h0 = _ssd_inputs(1, 70, 2, 4, 3, seed=2)
    w = np.random.default_rng(3).standard_normal((1, 70, 2, 3)).astype(
        np.float32)
    wh = np.random.default_rng(4).standard_normal((1, 2, 4, 3)).astype(
        np.float32)

    def jloss(v, k, q, ld, h0):
        y, h = JS.ssd_chunked(v, k, q, ld, chunk=16, h0=h0)
        return jnp.sum(y * w) + jnp.sum(h * wh)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (v, k, q, ld, h0)))
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in (v, k, q, ld, h0)]
    y, h = TS.ssd_chunked(*args[:4], chunk=16, h0=args[4])
    got = torch.autograd.grad(torch.sum(y * torch.from_numpy(w))
                              + torch.sum(h * torch.from_numpy(wh)), args)
    for g, wg in zip(got, want):
        assert torch.isfinite(g).all()
        close_to(g, wg, 1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_decode_step_matches_reference(dtype):
    v, k, q, ld, h0 = _ssd_inputs(2, 1, 3, 8, 5, seed=5)
    jv, tv = _pair(v[:, 0], dtype)
    jy, jh = JS.ssd_decode_step(jnp.asarray(h0), jv, jnp.asarray(k[:, 0]),
                                jnp.asarray(q[:, 0]), jnp.asarray(ld[:, 0]))
    ty, th = TS.ssd_decode_step(torch.from_numpy(h0), tv,
                                torch.from_numpy(k[:, 0]),
                                torch.from_numpy(q[:, 0]),
                                torch.from_numpy(ld[:, 0]))
    assert ty.dtype == _td(dtype) and th.dtype == torch.float32
    close_to(ty, jy, _tol(dtype))
    close_to(th, jh, F32_TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv1d_matches_reference(dtype, with_state):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    jst, tst = _pair(st, dtype) if with_state else (None, None)
    jy, jnew = JS.causal_conv1d(jx, jw, jst)
    ty, tnew = TS.causal_conv1d(tx, tw, tst)
    assert ty.dtype == tnew.dtype == _td(dtype) and tnew.shape == (2, 3, 6)
    close_to(ty, jy, _tol(dtype))
    close_to(tnew, jnew, 0)


# ---------------------------------------------------------------------------
# the three mixers
# ---------------------------------------------------------------------------

# mixer → (arch, spec field, the spec's chunk replaced so that 40 steps
# run 3 chunks, the last one partial; init; forward; decode; the state
# the forward returns as the decode's state)
MIXERS = {
    "mamba2": ("zamba2-1.2b", "mamba", {"chunk": 16}, JS.mamba2_init,
               "mamba2_forward", "mamba2_decode"),
    "mlstm": ("xlstm-350m", "mlstm", {"chunk": 16}, JS.mlstm_init,
              "mlstm_forward", "mlstm_decode"),
    "slstm": ("xlstm-350m", "slstm", {}, JS.slstm_init, "slstm_forward",
              "slstm_decode"),
}


def _close_state(got, want, tol):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_state(g, w, tol)
        return
    assert got.shape == tuple(want.shape)
    close_to(got, want, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mixer", list(MIXERS))
def test_mixer_forward_matches_reference(mixer, dtype):
    arch, field, kw, init, fwd, _ = MIXERS[mixer]
    jspec, tspec = _spec(arch, field, **kw)
    jp, tp = _params(init, jspec, seed=7, dtype=dtype)
    x = np.random.default_rng(8).standard_normal(
        (2, 40, jspec.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jy, jst = getattr(JS, fwd)(jp, jspec, jx)
    ty, tst = getattr(TS, fwd)(tp, tspec, tx)
    assert ty.dtype == _td(dtype) and ty.shape == (2, 40, jspec.d_model)
    close_to(ty, jy, _tol(dtype))
    # the carried states are f32; Mamba2's conv state is in x's dtype
    flat = tst if isinstance(tst, tuple) else (tst,)
    assert [t.dtype for t in flat] == [_t(a).dtype for a in (
        jst if isinstance(jst, tuple) else (jst,))]
    _close_state(tst, jst, _tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mixer", list(MIXERS))
def test_mixer_decode_matches_reference(mixer, dtype):
    """One decode step from the state the reference's forward over the
    first 11 tokens leaves (for mLSTM that state is scaled by the
    stabiliser; the reference's decode adds unscaled terms, and so does
    the port's)."""
    arch, field, kw, init, fwd, dec = MIXERS[mixer]
    jspec, tspec = _spec(arch, field, **kw)
    jp, tp = _params(init, jspec, seed=9, dtype=dtype)
    x = np.random.default_rng(10).standard_normal(
        (2, 12, jspec.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    _, jst = getattr(JS, fwd)(jp, jspec, jx[:, :11])
    jy, jnew = getattr(JS, dec)(jp, jspec, jx[:, 11:], jst)
    ty, tnew = getattr(TS, dec)(tp, tspec, tx[:, 11:], _t(jst))
    assert ty.dtype == _td(dtype) and ty.shape == (2, 1, jspec.d_model)
    close_to(ty, jy, _tol(dtype))
    _close_state(tnew, jnew, _tol(dtype))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("mixer", list(MIXERS))
def test_mixer_bf16_gradients_carry_the_reference_precision(mixer):
    """The gradients of Σ y·w with respect to the f32 masters and x, the
    forward on the train step's bf16 cast: per leaf, the port's bf16
    gradient lies from the reference's f32 gradient within twice the
    reference's own bf16 distance (measured: the port's at most the
    reference's, but for Mamba2's d_skip 0.016 against 0.035)."""
    arch, field, kw, init, fwd, _ = MIXERS[mixer]
    jspec, tspec = _spec(arch, field, **kw)
    jp, _ = _params(init, jspec, seed=7, dtype="float32")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 40, jspec.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 40, jspec.d_model)).astype(np.float32)

    def jloss(p, x, dt):
        pc = jax.tree.map(lambda v: v.astype(dt)
                          if v.dtype == jnp.float32 and v.ndim > 1 else v, p)
        y = getattr(JS, fwd)(pc, jspec, x.astype(dt))[0]
        return jnp.sum(y.astype(jnp.float32) * w)

    want32 = jax.grad(jloss, (0, 1))(jp, jnp.asarray(x), jnp.float32)
    want16 = jax.grad(jloss, (0, 1))(jp, jnp.asarray(x), jnp.bfloat16)
    tp = {k: _t(v).requires_grad_(True) for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    pc = {k: v.to(torch.bfloat16) if v.dim() > 1 else v
          for k, v in tp.items()}
    y, _ = getattr(TS, fwd)(pc, tspec, tx.to(torch.bfloat16))
    got = torch.autograd.grad(torch.sum(y.float() * torch.from_numpy(w)),
                              [*tp.values(), tx])
    for name, g in zip([*tp, "x"], got):
        g32, g16 = ((want32[1], want16[1]) if name == "x"
                    else (want32[0][name], want16[0][name]))
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        d_ref, d_port = _rel(g16, g32), _rel(g.numpy(), g32)
        assert d_port <= 2 * d_ref, (name, d_port, d_ref)


def test_mlstm_stabiliser_carries_no_gradient():
    """The max-stabiliser m̂ is detached: scaling every input-gate logit's
    max by a shift changes no output, and the gradient through m̂ is the
    reference's (``stop_gradient``): the f32 gradients of the input match
    ``jax.grad``."""
    jspec, tspec = _spec("xlstm-350m", "mlstm", chunk=16)
    jp, tp = _params(JS.mlstm_init, jspec, seed=11, dtype="float32")
    x = np.random.default_rng(12).standard_normal(
        (1, 20, jspec.d_model)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(JS.mlstm_forward(jp, jspec, a)[0]))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _ = TS.mlstm_forward(tp, tspec, tx)
    (got,) = torch.autograd.grad(torch.sum(y), [tx])
    close_to(got, want, 1e-4)


def test_modules_hold_the_reference_shapes_and_dtypes():
    """Each mixer module's parameters: the reference's names, shapes and
    dtypes (the f32 leaves stay f32 in a bf16 module)."""
    gen = torch.Generator().manual_seed(0)
    for mixer, (arch, field, kw, init, _, _) in MIXERS.items():
        jspec, tspec = _spec(arch, field, **kw)
        cls = {"mamba2": TS.Mamba2, "mlstm": TS.Mlstm, "slstm": TS.Slstm}[
            mixer]
        for jd, td in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
            jp, _ = init(jax.random.PRNGKey(0), jspec, jd)
            mod = cls(tspec, gen, td)
            got = {k: (tuple(p.shape), p.dtype)
                   for k, p in mod.named_parameters()}
            want = {k: (tuple(v.shape), _t(v).dtype) for k, v in jp.items()}
            assert got == want, mixer
