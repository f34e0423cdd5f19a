"""ScreeningEngine: every screening rule through the streaming matvec.

X is fixed along the λ-path, so the column norms, |Xᵀy|, λ_max and the
λ_max ray v₁ are λ-independent. :class:`DictionaryGeometry` caches the
query-independent part (X, ‖x_j‖², ‖x_j‖ — one fused
``edpp_screen_scores`` pass with a zero centre at fit);
:class:`PathWorkspace` adds one query (|Xᵀy| from one ``screen_matvec``
pass, λ_max, the argmax feature, v₁ and its cut normal ĝ = v₁/‖v₁‖).
Every screen is then one ``screen_matvec`` pass with the cached norms
(``last_x_passes == 1``; two for DOME, none for ``none``).

The ops dispatch through :mod:`repro_torch.kernels.ops`: the ``cuda``
backend on the card, the plain ``torch`` versions on the CPU. On a mesh
(``DictionaryGeometry(..., mesh=)``) X is the rank's column block and
the backend is :func:`.distributed.sharded_backend`, whose dots and norms
come back gathered in global column order: λ_max and its feature
``istar`` are then the global maximum and its lowest global index, and
the λ_max column is gathered from the rank that holds it.

The group twins (:class:`GroupDictionaryGeometry`,
:class:`GroupScreeningEngine`) cache the per-group spectral norms ‖X_g‖₂
at fit, λ̄_max and v̄₁ per query, and score every group screen with one
``group_screen_scores`` pass over X.

A (B, n) query batch fits all B queries with the same one pass (one
``edpp_screen_scores`` launch without a geometry, one ``screen_matvec``
launch with one): ``lam_max`` and ``istar`` become (B,) host arrays, v₁
and ĝ (B, n). A batched screen takes a (B,) λ and streams the same
passes as one query's, each one ``screen_matvec`` call for the whole
batch (``last_x_passes`` counts the batch once). Every per-query scalar
— a sphere's centre and radius, GAP's ‖Xᵀθ₀‖∞ and gap radius, the cut
offset b = 1/‖g‖, DOME's and the cuts' t_b, each threshold — is built
by the rank-1 rule on host-float λ and fresh rows, and the combine is
elementwise, so a batched mask is bit for bit the single query's mask
from the same state.

Rules (the reference's screens): the sequential spheres, GAP (its
feasibility rescale ‖Xᵀθ₀‖∞ from the same matvec as its scores), basic
SAFE, the strong rule, DOME (two passes: the centre's and ĝ's dots),
every ``<base>_cut`` (the centre and the cached cut normal ĝ stacked
into one matvec: one pass), and ``none``; group EDPP, group strong and
``none`` (rank-1 queries; a group batch loops them, as the reference
does). A dictionary edit patches the geometry in place
(:meth:`DictionaryGeometry.apply_update`, driven by ``session.update``;
see :mod:`.update`).

Mixed precision (``screen_dtype="bfloat16"``, every rule but ``none``:
:data:`BF16_FAST_RULES`, one query or a batch, on a mesh too). The wide
pass streams the geometry's bf16 copy of X (half the bytes; DOME's two
directions stacked into one pass), and each score gets a certified band
from the measured per-column error (``kernels.ops.bf16_score_margin``):
one scalar band for the spheres and the strong rule, per-piece
intervals through :func:`~.screening.dome_score_bounds` for DOME and the
cuts. Outside the band the bf16 decision is provably the float32 one;
the band's columns are gathered into a bucket of
:func:`_narrow_bucket` width and re-tested in float32 with the dots the
wide float32 pass gives at those columns (``matvec(..., wide_p=...)``,
the width that pass streams: p, or the rank's p/F on a mesh, where the
bf16 pass reads the rank's block of the copy, the error bound is
gathered to all p columns and the band's gather is replicated), so the
mask is the float32 engine's bit for bit. GAP first recovers its
rescale ‖Xᵀθ₀‖∞ exactly from a narrow float32 gather of the argmax
candidates (:func:`_gap_cand`). Passes and bytes are counted as the
reference counts them: the wide pass at 2 bytes an element, plus one
pass of n·bucket·4 bytes when a band is re-tested (GAP and gap_cut
always pay their candidate gather as that one pass).
"""

from __future__ import annotations

from typing import NamedTuple

import warnings

import numpy as np
import torch

from ..kernels import ops
from . import distributed as dist
from . import group_screening as gscr
from . import screening as scr

#: HBM passes over X that one screen takes through the engine, per rule:
#: the ``<base>_cut`` rules stack ĝ into the centre's matvec (one pass),
#: DOME streams the centre and ĝ separately (two).
ENGINE_X_PASSES = {"strong": 1, "dome": 2, "none": 0, "safe": 1,
                   **{f"{b}_cut": 1 for b in scr.SPHERE_RULES}}

#: Every Lasso rule the engine serves (the reference's float32 screens).
ENGINE_RULES = (*scr.SPHERE_RULES, *scr.CUT_RULES, "safe", "dome", "strong",
                "none")

#: Rules the group engine serves (the reference's group subset).
GROUP_ENGINE_RULES = (*gscr.GROUP_RULES, "none")


#: Rules the bf16 fast pass serves with a certified margin (the
#: reference's ``ScreeningEngine.BF16_FAST_RULES``): every rule of
#: ENGINE_RULES but ``none``, which streams nothing.
BF16_FAST_RULES = ("dpp", "imp1", "imp2", "edpp", "seq_safe", "safe",
                   "strong", "gap", "dome",
                   *(f"{b}_cut" for b in scr.SPHERE_RULES))


#: HBM passes over X that one screen takes through the plain oracle mask
#: of :mod:`.screening` (the reference's count): the cut rules pay
#: Xᵀcentre, the column norms, Xᵀy for the cut and Xᵀĝ.
ORACLE_X_PASSES = {"strong": 1, "dome": 4, "none": 0, "safe": 2,
                   **{f"{b}_cut": 4 for b in scr.SPHERE_RULES}}


def engine_x_passes(rule: str) -> int:
    """HBM passes over X per screen through the engine (1 for ball rules)."""
    return ENGINE_X_PASSES.get(rule, 1)


def oracle_x_passes(rule: str) -> int:
    """HBM passes over X per screen through the plain oracle mask (2 for
    ball rules: the centre's dots and the column norms)."""
    return ORACLE_X_PASSES.get(rule, 2)


# ---------------------------------------------------------------------------
# Backend registry: the reference's helpers over kernels.ops.BACKENDS
# ---------------------------------------------------------------------------

def available_backends() -> tuple[str, ...]:
    return tuple(ops.BACKENDS)


def register_backend(name: str, backend: ops.ScreenBackend) -> None:
    """Add a :class:`~repro_torch.kernels.ops.ScreenBackend` under
    ``name``; select it with ``ScreenSpec(backend=name)`` or
    ``SolveSpec(backend=name)``. It runs only where it is named: the
    built-in ``cuda`` and ``torch`` cannot be replaced, and the default
    stays ``cuda`` on the card."""
    if name in ("cuda", "torch"):
        raise ValueError(f"backend {name!r} is built in and cannot be "
                         f"replaced")
    if not isinstance(backend, ops.ScreenBackend):
        raise TypeError(f"register a ScreenBackend, got "
                        f"{type(backend).__name__}")
    ops.BACKENDS[name] = backend


# The screening backend an engine takes when none is named (``cuda`` on
# the card, the default device; ``torch`` on the CPU), and a name's
# backend.
default_backend = ops.default_backend_name
resolve_backend = ops.resolve_backend


def block_scores(Xb: torch.Tensor, centre: torch.Tensor, rho,
                 col_norms: torch.Tensor | None = None) -> torch.Tensor:
    """Sphere scores |x_jᵀc| + ρ‖x_j‖ of one column block (the
    distributed layer's per-block step), through the backend of the
    block's device. Without ``col_norms`` they
    are the fused ``edpp_screen_scores`` pass's scores; with the norms
    that pass gave (√sumsq) they take the engine's arithmetic
    (``screen_matvec`` and the cached norms), which gives the same bits
    on the CPU, so a sharded and an unsharded screen agree bit for bit
    on the same block."""
    be = ops.resolve_backend(None, Xb.device)
    if col_norms is None:
        return be.fused_scores(Xb, centre, rho)[0]
    dot = be.matvec(Xb, centre)
    rho_t = torch.as_tensor(rho, dtype=dot.dtype, device=dot.device)
    return torch.abs(dot) + rho_t * col_norms


def _narrow_bucket(k: int, p: int) -> int:
    """Width of a narrow float32 gather of k columns: the smallest of
    8, 16, 24, 32, 48, 64, 96, … (powers of two and their 3/4 points,
    all multiples of 8) that holds k, capped at p."""
    b = 1 << max(0, (max(k, 8) - 1).bit_length())
    if b >= 32 and 3 * b // 4 >= k:
        b = 3 * b // 4
    return min(b, p)


def _gap_cand(dot: torch.Tensor, margin: torch.Tensor) -> torch.Tensor:
    """GAP's argmax candidates for the exact rescale, per row of (B, p)
    bf16 dots: the columns whose upper bound |d̃_j| + m_j reaches the best
    lower bound max_k(|d̃_k| − m_k), floored at 1 (every consumer reads
    ‖Xᵀθ₀‖∞ through max(1, ·), so a column whose bound stays under 1
    cannot move it). The true float32 argmax is a candidate whenever
    the sup exceeds 1."""
    a = torch.abs(dot)
    lo = torch.clamp(a - margin, min=0.0)
    t = torch.clamp(torch.amax(lo, dim=-1), min=1.0)
    return a + margin >= t[:, None]


# Rules asked to screen in bfloat16 that no certified margin covers run
# float32, with one warning per rule and process (the effective dtype is
# also in PathStepStats.screen_dtype_effective).
_BF16_FALLBACK_WARNED: set[str] = set()


def _note_f32_fallback(rule: str) -> None:
    if rule in _BF16_FALLBACK_WARNED:
        return
    _BF16_FALLBACK_WARNED.add(rule)
    warnings.warn(f"screen_dtype='bfloat16' has no certified margin for "
                  f"rule {rule!r}; screening it in float32 instead (masks "
                  f"unchanged, no byte saving)", RuntimeWarning,
                  stacklevel=4)


def _stream_fit_single(xstar: torch.Tensor, y: torch.Tensor):
    """The λ_max ray v₁ = sign(x*ᵀy)·x* (eq. 17 at λ₀ = λ_max) and its
    feasibility cut (ĝ = v₁/(‖v₁‖ + 1e-30), b = 1/(‖v₁‖ + 1e-30))."""
    v1 = torch.sign(torch.dot(xstar, y)) * xstar
    return v1, scr.cut_from_ray(v1)


def _stream_fit_batched(xstar: torch.Tensor, Y: torch.Tensor):
    """v₁ per query from the (B, n) argmax columns, f32 accumulation, and
    each row's cut from the rank-1 rule (a list of B cuts)."""
    acc = torch.promote_types(xstar.dtype, torch.float32)
    sgn = torch.sign(torch.sum(xstar.to(acc) * Y.to(acc), dim=-1))
    v1 = sgn.to(xstar.dtype)[:, None] * xstar
    return v1, [scr.cut_from_ray(v.clone()) for v in v1]


class _ColumnGeometry:
    """The reads of the global X that both geometries serve, from X (the
    rank's block of whole columns on a mesh, ``p`` global columns): the
    path's buckets, Xβ and the KKT check's Xᵀr."""

    X: torch.Tensor
    mesh: object
    p: int
    backend: ops.ScreenBackend

    def columns(self, cols, width: int | None = None) -> torch.Tensor:
        """Global columns ``cols`` (host indices) of X as an (n, width)
        block zero-padded past ``len(cols)`` (``width`` defaults to it),
        the same on every rank: the path's reduced buckets and the λ̄_max
        group."""
        return _take_columns(self.X, cols, width, self.mesh)

    def fitted(self, beta: torch.Tensor) -> torch.Tensor:
        """Xβ (n,) for a global β (p,), or βXᵀ (B, n) for β (B, p), the
        same on every rank. On a mesh each rank's block product is summed
        by one all-reduce, which orders the sum by rank: the path never
        reads it (its states and KKT checks take X_r·β_r from the reduced
        bucket), so it is not held to the unsharded bits."""
        if self.mesh is None:
            return beta @ self.X.T if beta.dim() == 2 else self.X @ beta
        return dist.fitted_values(self.mesh, self.X, beta)

    def correlations(self, r: torch.Tensor) -> torch.Tensor:
        """Xᵀr (p,) for r (n,), or rX (B, p) for r (B, n), in global column
        order, the same on every rank: the KKT check's dots, through the
        backend's ``matvec`` (``screen_matvec``). On a mesh the rank's
        block is launched with ``wide_p`` = p and gathered, so each dot
        is summed as the unsharded pass sums it on any feature size (a
        BLAS product blocks by width and would not keep that)."""
        if self.mesh is None:
            return self.backend.matvec(self.X, r)
        return dist.gather_features(
            self.mesh, self.backend.matvec(self.X, r, wide_p=self.p))


class DictionaryGeometry(_ColumnGeometry):
    """The query-independent geometry of a fitted dictionary X: X on its
    device, ‖x_j‖² and ‖x_j‖ (global, p of them). ``_sumsq`` adopts a fit
    made elsewhere (``fit_passes`` then stays 0). With ``mesh``, X is the
    rank's column block of a global X with ``p`` columns.

    ``version`` counts the edits :meth:`apply_update` made (0 at fit);
    ``update_passes`` the passes over added blocks they ran."""

    def __init__(self, X: torch.Tensor, backend=None, *, _sumsq=None,
                 mesh=None):
        self.X = X
        self.mesh = mesh
        self.p = X.shape[1] * (1 if mesh is None else dist.feature_size(mesh))
        self.backend = ops.resolve_backend(backend, X.device)
        self.fit_passes = 0       # fused workspace passes over X
        self.query_passes = 0     # per-query |Xᵀy| attach passes
        self.update_passes = 0    # passes over an update's added block
        self.version = 0
        self.last_update_bytes = 0.0   # collective bytes of the last edit
        # False until an update has replaced every buffer: X may alias a
        # caller's array (a float32 numpy X on the CPU), so the first
        # update copies before it patches in place
        self._owns_buffers = False
        if _sumsq is None:
            zero = torch.zeros((X.shape[0],), dtype=X.dtype, device=X.device)
            _, _sumsq = self.backend.fused_scores(X, zero, 0.0)
            self.fit_passes = 1
        self.sumsq = _sumsq
        self.col_norms = torch.sqrt(_sumsq)
        self._screen_copies: dict[str, torch.Tensor] = {}

    def screen_copy(self, dtype: torch.dtype) -> torch.Tensor:
        """A reduced-precision copy of X for the screens' wide pass, made
        on first use (``X.to(dtype)``: round to nearest even) and kept for
        the geometry's lifetime (on a mesh: of the rank's block).
        ``sumsq``, the column norms and every query's |Xᵀy| stay the
        full-precision fit's."""
        if dtype == self.X.dtype:
            return self.X
        key = str(dtype)
        cached = self._screen_copies.get(key)
        if cached is None:
            cached = self._screen_copies[key] = self.X.to(dtype)
        return cached

    def screen_err(self, dtype: torch.dtype) -> torch.Tensor:
        """The per-column dot-error bound (p,) of ``screen_copy(dtype)``
        (``kernels.ops.bf16_column_err``), kept like the copy; zero when
        the copy is X itself. Global on a mesh: each rank bounds its own
        columns and one all-gather puts the p bounds on every rank."""
        if dtype == self.X.dtype:
            return torch.zeros_like(self.col_norms)
        key = f"{dtype}:err"
        cached = self._screen_copies.get(key)
        if cached is None:
            cached = self._screen_copies[key] = self._err(
                self.X, self.screen_copy(dtype), gather=True)
        return cached

    def _err(self, X, X_lo, gather: bool) -> torch.Tensor:
        err = ops.bf16_column_err(X, X_lo)
        if gather and self.mesh is not None:
            err = dist.gather_features(self.mesh, err)
        return err

    def copy_columns(self, dtype: torch.dtype, cols,
                     width: int | None = None) -> torch.Tensor:
        """:meth:`columns` of ``screen_copy(dtype)``: the bf16 solve's
        bucket, the same bits as the float32 bucket rounded."""
        return _take_columns(self.screen_copy(dtype), cols, width, self.mesh)

    # ---------------------------------------------------------- updates
    def apply_update(self, plan, X_add: torch.Tensor | None = None) -> int:
        """Apply a column edit (:class:`~.update.UpdatePlan`) in place and
        return the new ``version``. ``X_add`` (n, n_add) is on X's device
        (replicated on a mesh).

        A balanced edit (``plan.pure_recycle``) writes the added columns
        into the recycled slots of X (on a mesh: the slots in the rank's
        block) and of every screen copy (the cast of the added block:
        elementwise, so the cold cast's bits), and patches ‖x_j‖², ‖x_j‖
        and every ``:err`` bound at those slots from one pass over the
        added block. That pass is launched with the width of the pass
        that owns the columns (``wide_p``: p off a mesh, the rank's p/F
        on one), so its sums are a cold fit's bits; the error bound sums
        by a fixed tree on any device (``kernels.ref.sum_rows``). Every
        survivor's state is untouched. The first update copies every
        buffer before it writes (X may alias a caller's array); later
        ones patch in place.

        A shape-changing edit builds the edited X, [X[:, keep], X_add's
        tail] with the recycled slots patched (on a mesh each rank's new
        block from its owners, one ``gather_columns`` a destination rank;
        no rank holds the whole X), and refits ‖x_j‖², the screen copies
        and their bounds at the new width, as a cold fit does."""
        n = self.X.shape[0]
        if X_add is not None and (X_add.dim() != 2 or X_add.shape[0] != n):
            raise ValueError(f"X_add must be (n, p_add) with n={n}, got "
                             f"{tuple(X_add.shape)}")
        self.last_update_bytes = 0.0
        if X_add is not None:
            self.update_passes += 1
        if plan.pure_recycle:
            if plan.n_recycle:
                self._patch(plan.recycle_idx, X_add)
        else:
            self._rebuild(plan, X_add)
        self.version += 1
        return self.version

    def _local(self, cols: np.ndarray, p: int):
        """(the rank's positions, the positions in ``cols``) of the global
        columns ``cols`` of a width-p layout that fall in the rank's block
        (all of them off a mesh)."""
        cols = np.asarray(cols, dtype=np.int64)
        if self.mesh is None:
            return cols, np.arange(cols.size)
        lo, hi = dist.feature_range(self.mesh, p)
        sel = np.flatnonzero((cols >= lo) & (cols < hi))
        return cols[sel] - lo, sel

    def _own(self) -> None:
        """Copy every buffer once, so patches never write a caller's X."""
        if self._owns_buffers:
            return
        self.X = self.X.clone()
        self.sumsq = self.sumsq.clone()
        self.col_norms = self.col_norms.clone()
        self._screen_copies = {k: v.clone()
                               for k, v in self._screen_copies.items()}
        self._owns_buffers = True

    def _patch(self, slots: np.ndarray, X_add: torch.Tensor) -> None:
        """The balanced edit: X_add's columns into ``slots`` (ascending)."""
        self._own()
        dev = self.X.device
        blk = X_add.to(self.X.dtype).contiguous()
        zero = torch.zeros((blk.shape[0],), dtype=blk.dtype, device=dev)
        _, ss = self.backend.fused_scores(blk, zero, 0.0,
                                          wide_p=self.X.shape[1])
        idx = torch.from_numpy(np.asarray(slots, dtype=np.int64)).to(dev)
        self.sumsq.index_copy_(0, idx, ss)
        self.col_norms.index_copy_(0, idx, torch.sqrt(ss))
        local, sel = self._local(slots, self.p)
        lidx = torch.from_numpy(local).to(dev)
        mine = blk.index_select(1, torch.from_numpy(sel).to(dev))
        self.X.index_copy_(1, lidx, mine)
        for key, val in self._screen_copies.items():
            if key.endswith(":err"):
                dt = _dtype_of(key[:-4])
                val.index_copy_(0, idx, self._err(blk, blk.to(dt),
                                                  gather=False))
            else:
                val.index_copy_(1, lidx, mine.to(val.dtype))

    def _rebuild(self, plan, X_add: torch.Tensor | None) -> None:
        """The shape-changing edit: the edited X at its new width, then
        the per-column state refitted there."""
        dev = self.X.device
        p_new = plan.p_new
        if self.mesh is None:
            X_new = torch.empty((self.X.shape[0], p_new), dtype=self.X.dtype,
                                device=dev)
            X_new[:, :plan.keep_idx.size] = self.X.index_select(
                1, torch.from_numpy(plan.keep_idx).to(dev))
        else:
            X_new, self.last_update_bytes = dist.relayout_columns(
                self.mesh, self.X, plan.keep_idx, p_new)
        if X_add is not None:
            blk = X_add.to(self.X.dtype)
            # the recycled slots' new positions and the appended tail
            touched = plan.touched_new_idx
            local, sel = self._local(touched, p_new)
            X_new[:, torch.from_numpy(local).to(dev)] = blk[
                :, torch.from_numpy(sel).to(dev)]
        self.X = X_new.contiguous()
        self.p = p_new
        zero = torch.zeros((self.X.shape[0],), dtype=self.X.dtype, device=dev)
        _, ss = self.backend.fused_scores(self.X, zero, 0.0)
        self.sumsq, self.col_norms = ss, torch.sqrt(ss)
        copies: dict[str, torch.Tensor] = {}
        for key in self._screen_copies:
            if not key.endswith(":err"):
                copies[key] = self.X.to(_dtype_of(key))
        for key in self._screen_copies:
            if key.endswith(":err"):
                copies[key] = self._err(self.X, copies[key[:-4]], gather=True)
        self._screen_copies = copies
        self._owns_buffers = True


def _dtype_of(key: str) -> torch.dtype:
    """The torch dtype of a screen copy's key (``str(dtype)``)."""
    return getattr(torch, key.split(".")[-1])


def _take_columns(X: torch.Tensor, cols, width, mesh) -> torch.Tensor:
    """Global columns ``cols`` of X (the rank's block on a mesh) as an
    (n, width) block zero-padded past ``len(cols)``, the same on every
    rank."""
    if mesh is not None:
        return dist.gather_columns(mesh, X, cols, width)
    cols = np.asarray(cols, dtype=np.int64)
    out = torch.zeros((X.shape[0], cols.size if width is None else width),
                      dtype=X.dtype, device=X.device)
    out[:, :cols.size] = X[:, cols]
    return out


class PathWorkspace:
    """A :class:`DictionaryGeometry` plus the query fit: |Xᵀy|, λ_max, the
    first index attaining it (``istar``), v₁ and the λ_max feasibility
    cut (``cuts``: one :class:`~.screening.HalfSpaceCut` per query, its
    normal ĝ = v₁/‖v₁‖). Without ``geometry`` one fused pass fits X and
    the query together. ``y`` (B, n) fits a batch in the same one pass:
    ``lam_max`` (float64) and ``istar`` are then (B,) host arrays and v₁
    is (B, n). A workspace kept across ``session.update`` is refreshed by
    :func:`~.update.update_workspace`."""

    def __init__(self, X, y: torch.Tensor, backend=None, *,
                 geometry: DictionaryGeometry | None = None):
        if y.dim() not in (1, 2):
            raise ValueError(f"queries must be (n,) or (B, n), got shape "
                             f"{tuple(y.shape)}")
        self.y = y
        self.batch = None if y.dim() == 1 else y.shape[0]
        if geometry is None:
            backend_r = ops.resolve_backend(backend, X.device)
            scores, sumsq = backend_r.fused_scores(X, y, 0.0)
            geometry = DictionaryGeometry(X, backend_r, _sumsq=sumsq)
            geometry.fit_passes = 1
            geometry.query_passes += 1
            self.geometry = geometry
            self._set_scores(scores)
        else:
            self.geometry = geometry
            self.attach()

    @property
    def backend(self) -> ops.ScreenBackend:
        return self.geometry.backend

    def attach(self) -> None:
        """Fit the query to the geometry: |Xᵀy| from one ``screen_matvec``
        pass over X, then λ_max, its feature, v₁ and the cut."""
        geom = self.geometry
        scores = torch.abs(geom.backend.matvec(geom.X, self.y))
        geom.query_passes += 1
        self._set_scores(scores)

    def _set_scores(self, scores: torch.Tensor) -> None:
        self.abs_xty = scores
        # torch.argmax returns the first maximal index, like jnp.argmax
        if self.batch is None:
            self.set_argmax(int(torch.argmax(scores)))
        else:
            self.set_argmax(torch.argmax(scores, dim=-1).cpu().numpy())

    def set_argmax(self, istar) -> None:
        """λ_max = |Xᵀy| at ``istar`` (an index, or (B,) indices), and v₁
        and the λ_max cut from that column of X."""
        self._state_max = None
        geom, y = self.geometry, self.y
        if self.batch is None:
            self.istar = int(istar)
            self.lam_max = float(self.abs_xty[self.istar])
            self.v1_at_lmax, cut = _stream_fit_single(
                geom.columns([self.istar])[:, 0], y)
            self.cuts = [cut]
        else:
            self.istar = np.asarray(istar, dtype=np.int64)
            idx = torch.from_numpy(self.istar).to(self.abs_xty.device)
            self.lam_max = self.abs_xty.gather(1, idx[:, None])[:, 0].cpu() \
                .numpy().astype(np.float64)
            self.v1_at_lmax, self.cuts = _stream_fit_batched(
                geom.columns(self.istar).T, y)

    @property
    def X(self) -> torch.Tensor:
        return self.geometry.X

    @property
    def sumsq(self) -> torch.Tensor:
        return self.geometry.sumsq

    @property
    def col_norms(self) -> torch.Tensor:
        return self.geometry.col_norms

    def state_at_lambda_max(self) -> scr.DualState:
        """β* = 0, θ* = y/λ_max (eq. 9), from the cache. Batched, each row
        of θ is the single query's y/λ_max (a host-float division)."""
        if self._state_max is not None:
            return self._state_max
        dev, dt = self.X.device, self.X.dtype
        if self.batch is None:
            st = scr.DualState(
                theta=self.y / self.lam_max, lam=self.lam_max,
                v1=self.v1_at_lmax, at_lmax=True,
                beta_l1=torch.zeros((), dtype=dt, device=dev))
        else:
            st = scr.DualState(
                theta=torch.stack([yb / float(lm) for yb, lm
                                   in zip(self.y, self.lam_max)]),
                lam=self.lam_max.copy(), v1=self.v1_at_lmax,
                at_lmax=np.ones((self.batch,), dtype=bool),
                beta_l1=torch.zeros((self.batch,), dtype=dt, device=dev))
        self._state_max = st
        return st


class ScreeningEngine:
    """One entry point for every per-step screen on a λ-path::

        eng = ScreeningEngine(X, y, geometry=geom)    # one |Xᵀy| pass
        state = eng.state_at_lambda_max()
        for lam in grid:
            discard = eng.screen(lam, state, rule="edpp")   # one X pass
            ... reduced solve -> beta, fitted = X_r β_r ...
            state = eng.make_state(beta, lam, fitted=fitted)

    ``last_x_passes`` / ``total_x_passes`` / ``last_screen_bytes`` count
    full passes over X (and their bytes) for the path stats;
    ``last_effective_dtype`` is the dtype the last screen's wide pass
    streamed and ``last_fallback_cols`` the band columns it re-tested in
    float32 (``screen_dtype="bfloat16"``; see the module doc).
    """

    def __init__(self, X, y, backend=None, eps: float = scr.EPS_DEFAULT, *,
                 geometry: DictionaryGeometry | None = None,
                 screen_dtype: str = "float32"):
        if screen_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"screen_dtype must be 'float32' or "
                             f"'bfloat16', got {screen_dtype!r}")
        self.ws = PathWorkspace(X, y, backend, geometry=geometry)
        self.eps = eps
        self.screen_dtype = screen_dtype
        self._x_fast = self._x_fast_err = None
        if screen_dtype == "bfloat16":
            geom = self.ws.geometry
            self._x_fast = geom.screen_copy(torch.bfloat16)
            self._x_fast_err = geom.screen_err(torch.bfloat16)
        self.total_x_passes = 0
        self.last_x_passes = 0
        self.last_screen_bytes = 0.0
        self.last_fallback_cols = 0
        self.last_effective_dtype = "float32"

    @property
    def lam_max(self) -> float:
        return self.ws.lam_max

    @property
    def geometry(self) -> DictionaryGeometry:
        return self.ws.geometry

    @property
    def backend_name(self) -> str:
        return self.ws.backend.name

    @property
    def p(self) -> int:
        """Columns of the global X."""
        return self.ws.geometry.p

    def state_at_lambda_max(self) -> scr.DualState:
        return self.ws.state_at_lambda_max()

    @property
    def batch(self) -> int | None:
        return self.ws.batch

    def make_state(self, beta, lam, *, fitted=None) -> scr.DualState:
        """Sequential DualState from the solution at λ (KKT eq. 3), with the
        λ_max branch served from the cache. ``fitted`` (= Xβ, from the
        reduced bucket) skips the X·β pass. Batched: β (B, p), λ (B,) host
        values, fitted (B, n); the rows at their λ_max take the cached
        rows (the reference's ``_make_state_batched_fit``)."""
        ws = self.ws
        if ws.batch is not None:
            return self._make_state_batched(beta, lam, fitted)
        if scr.at_lmax(lam, ws.lam_max):
            return ws.state_at_lambda_max()
        if fitted is None:
            fitted = ws.geometry.fitted(beta)
        theta = (ws.y - fitted) / lam
        return scr.DualState(theta=theta, lam=lam, v1=ws.y / lam - theta,
                             at_lmax=False,
                             beta_l1=torch.sum(torch.abs(beta)))

    def _make_state_batched(self, beta, lam, fitted) -> scr.DualState:
        ws = self.ws
        lam = _host_rows(lam)
        at = scr.at_lmax_rows(lam, ws.lam_max)
        st_max = ws.state_at_lambda_max()
        if at.all():
            return st_max
        if fitted is None:
            fitted = ws.geometry.fitted(beta)
        lam_t = torch.as_tensor(lam, dtype=ws.y.dtype,
                                device=ws.y.device)[:, None]
        theta = (ws.y - fitted) / lam_t
        v1 = ws.y / lam_t - theta
        # ‖β‖₁ per row, each summed as a single query's (GAP's radius)
        beta_l1 = torch.stack([torch.sum(torch.abs(b)) for b in beta])
        if at.any():
            at_t = torch.from_numpy(at).to(ws.y.device)
            theta = torch.where(at_t[:, None], st_max.theta, theta)
            v1 = torch.where(at_t[:, None], st_max.v1, v1)
            beta_l1 = torch.where(at_t, st_max.beta_l1, beta_l1)
        return scr.DualState(theta=theta, lam=np.where(at, ws.lam_max, lam),
                             v1=v1, at_lmax=at, beta_l1=beta_l1)

    def _count(self, passes: int, screen_bytes: float | None = None) -> None:
        self.last_x_passes = passes
        self.total_x_passes += passes
        if screen_bytes is None:
            screen_bytes = float(passes) * self.ws.X.shape[0] * self.p \
                * self.ws.X.element_size()
        self.last_screen_bytes = screen_bytes

    def _use_bf16(self, rule: str) -> bool:
        """Whether this screen streams the bf16 copy (then
        ``last_effective_dtype`` says so); a requested rule without a
        certified margin runs float32 with a one-time warning."""
        if self._x_fast is None:
            return False
        if rule in BF16_FAST_RULES:
            self.last_effective_dtype = "bfloat16"
            return True
        _note_f32_fallback(rule)
        return False

    def _query(self, b: int | None, lam: float, state) -> "_Query":
        """Query b of the batch (None: the single query) at λ, with the
        state the rank-1 rules take: host floats and fresh rows."""
        ws = self.ws
        if b is None:
            return _Query(ws.y, lam, ws.lam_max, state, ws.cuts[0],
                          ws.istar)
        return _Query(ws.y[b].clone(), lam, float(ws.lam_max[b]),
                      None if state is None else state.query(b),
                      ws.cuts[b], int(ws.istar[b]))

    def screen(self, lam_next, state: scr.DualState | None,
               rule: str = "edpp") -> torch.Tensor:
        """Discard mask bool[p] for λ_next (``engine_x_passes(rule)``
        streaming passes over X). Batched: λ_next (B,) → bool[B, p], the
        same passes for the whole batch."""
        ws = self.ws
        if ws.batch is None:
            return self._screen_rows([self._query(None, float(lam_next),
                                                  state)], rule)[0]
        lams = _host_rows(lam_next)
        return self._screen_rows([self._query(b, float(lam), state)
                                  for b, lam in enumerate(lams)], rule)

    def _matvec(self, rows: list[torch.Tensor]) -> torch.Tensor:
        """The stacked rows' dots with X in one ``screen_matvec`` call
        (one launch per MAX_B rows; one all-gather on a mesh)."""
        ws = self.ws
        return ws.backend.matvec(ws.X, torch.stack(rows))

    def _rows_of(self, values, ref: torch.Tensor) -> torch.Tensor:
        """Per-query scalars (host floats or 0-d tensors) as a (B, 1)
        column of ref's dtype and device."""
        return torch.stack([scr._like(v, ref) for v in values])[:, None]

    def _screen_rows(self, qs: list["_Query"], rule: str) -> torch.Tensor:
        """The (B, p) mask of B queries: the rule's rows stacked into its
        passes, each query's scalars from the rank-1 rules, one
        elementwise combine (:meth:`_decide`); through the bf16 copy with
        the margin fallback when ``screen_dtype`` asks for it."""
        ws = self.ws
        B = len(qs)
        self.last_effective_dtype = "float32"
        self.last_fallback_cols = 0
        if rule == "none":
            self._count(0)
            return torch.zeros((B, self.p), dtype=torch.bool,
                               device=ws.X.device)
        if rule not in ENGINE_RULES:
            raise ValueError(f"unknown screening rule {rule!r}; available: "
                             f"{ENGINE_RULES}")
        base = rule[:-4] if rule.endswith("_cut") else None
        sphere = base or rule
        eps = [self.eps] * B
        tests = None
        if rule == "strong":
            # |x_iᵀ(y − Xβ*(λ₀))| < 2λ − λ₀ (basic: the λ_max state)
            passes = [[q.state.theta * q.state.lam for q in qs]]
        elif rule == "dome":
            c = [q.y / q.lam for q in qs]
            tests = [scr.SphereTest(cb, scr._norm(q.y) * (
                1.0 / q.lam - 1.0 / q.lam_max)) for cb, q in zip(c, qs)]
            passes = [c, [q.cut.ghat for q in qs]]
        else:
            # a sphere (the rule's, or a cut's base) and, for a cut, ĝ
            # stacked into the same matvec
            if sphere == "gap":
                # the centre θ₀/max(1, ‖Xᵀθ₀‖∞) is rescaled from the same
                # dots (never the sphere with θ₀ assumed feasible)
                rows = [q.state.theta for q in qs]
            else:
                tests = [scr.safe_sphere(q.y, q.lam, q.lam_max)
                         if rule == "safe" else
                         scr.make_sphere(sphere, q.y, q.lam, q.state)
                         for q in qs]
                rows = [t.centre for t in tests]
                if rule == "safe":
                    # eq. 15's eps is at λ scale: eps/λ once normalised
                    eps = [self.eps / q.lam for q in qs]
            passes = [rows + ([q.cut.ghat for q in qs] if base else [])]

        def geometry(sup) -> dict:
            """Each query's scalars as (B, 1) columns: the threshold, the
            sphere's radius and cap threshold t_b, GAP's rescale."""
            ref = ws.col_norms
            if rule == "strong":
                return {"thr": self._rows_of(
                    [scr.strong_threshold(q.lam, q.state.lam, self.eps)
                     for q in qs], ref)}
            g = {"thr": self._rows_of([1.0 - e for e in eps], ref)}
            ts = tests
            if sphere == "gap":
                ts = [scr.gap_sphere(q.y, q.lam, q.state, sup_corr=sup[b])
                      for b, q in enumerate(qs)]
                g["s"] = torch.clamp(sup, min=1.0)[:, None]
            g["rho"] = self._rows_of([t.rho for t in ts], ref)
            if base or rule == "dome":
                g["t_b"] = self._rows_of(
                    [scr.dome_t_b(t.centre, t.rho, q.cut.ghat, q.cut.b)
                     for t, q in zip(ts, qs)], ref)
            return g

        if self._use_bf16(rule):
            mask = self._fast_screen(rule, sphere, base, B, passes,
                                     geometry)
        else:
            dot = torch.cat([self._matvec(rows) for rows in passes])
            sup = scr.sup_corr(dot[:B]) if sphere == "gap" else None
            mask = self._decide(rule, sphere, base, dot, ws.col_norms,
                                geometry(sup))
            self._count(engine_x_passes(rule))
        if rule == "dome":
            # the dome sup at x* is identically 1, on the threshold
            mask[torch.arange(B), torch.tensor([q.istar for q in qs])] = False
        return mask

    @staticmethod
    def _decide(rule: str, sphere: str, base, dot: torch.Tensor,
                norms: torch.Tensor, g: dict) -> torch.Tensor:
        """The float32 decision from the stacked rows' dots (the centres'
        B rows, then ĝ's for DOME and the cuts) at the columns whose norms
        are ``norms``: elementwise, so a gather of columns gives the
        decisions of the whole width at those columns."""
        if rule == "strong":
            return torch.abs(dot) < g["thr"]
        B = g["thr"].shape[0]
        dot_c = dot[:B] / g["s"] if sphere == "gap" and base else dot[:B]
        if base or rule == "dome":
            scores = scr.cap_scores(dot_c, dot[B:], norms, g["rho"],
                                    g["t_b"])
        elif sphere == "gap":
            scores = torch.abs(dot_c) / g["s"] + g["rho"] * norms
        else:
            scores = torch.abs(dot_c) + g["rho"] * norms
        return scores < g["thr"]

    @staticmethod
    def _certify(rule: str, sphere: str, base, dot: torch.Tensor,
                 margin: torch.Tensor, norms: torch.Tensor, g: dict):
        """(decision, band) from the bf16 pass's dots and their margins
        (one row of margins per stacked row): outside the band the
        decision is provably the float32 one; the band is what the
        float32 re-test must decide (the reference's ``*_margin``
        combines)."""
        B = g["thr"].shape[0]
        thr = g["thr"]
        if rule == "strong":
            a = torch.abs(dot)
            return a < thr, torch.abs(a - thr) <= margin
        e_c = margin[:B]
        if base or rule == "dome":
            s = g["s"] if sphere == "gap" else 1.0
            dc, e_g, dg = dot[:B], margin[B:], dot[B:]
            lo, hi = scr.dome_score_bounds(
                (dc - e_c) / s, (dc + e_c) / s, dg - e_g, dg + e_g, norms,
                g["rho"][:, 0], g["rho"][:, 0], g["t_b"][:, 0],
                g["t_b"][:, 0])
        elif sphere == "gap":
            a = torch.abs(dot)
            hi = (a + e_c) / g["s"] + g["rho"] * norms
            lo = torch.clamp(a - e_c, min=0.0) / g["s"] + g["rho"] * norms
        else:
            scores = torch.abs(dot) + g["rho"] * norms
            return scores < thr, torch.abs(scores - thr) <= e_c
        return hi < thr, (hi >= thr) & (lo < thr)

    def _fast_screen(self, rule: str, sphere: str, base, B: int, passes,
                     geometry) -> torch.Tensor:
        """One screen through the bf16 copy: every pass's rows stacked
        into one wide bf16 pass, GAP's exact rescale from its candidate
        gather, the certified decisions, and the band re-tested in
        float32 (:meth:`_retest`)."""
        ws = self.ws
        rows = [r for rs in passes for r in rs]
        stacked = torch.stack(rows)
        dot = ws.backend.matvec(self._x_fast, stacked)
        margin = ops.bf16_score_margin(
            self._x_fast_err, torch.stack([scr._norm(r) for r in rows]))
        sup, sup_bytes = None, 0.0
        if sphere == "gap":
            # stage 1: the exact rescale from the candidates' float32 dots
            # (the argmax is among them whenever the sup exceeds 1)
            cand = _gap_cand(dot[:B], margin[:B])
            dn, sup_bytes = self._gather_dots(_any_col(cand), stacked[:B])
            sup = scr.sup_corr(dn)
        g = geometry(sup)
        dec, band = self._certify(rule, sphere, base, dot, margin,
                                  ws.col_norms, g)
        mask, extra, narrow_bytes = self._retest(
            dec, band, stacked,
            lambda dn, cols: self._decide(rule, sphere, base, dn,
                                          ws.col_norms[cols], g))
        if sphere == "gap":
            # the candidate gather always runs: one narrow extra pass
            extra, narrow_bytes = 1, narrow_bytes + sup_bytes
        n = ws.X.shape[0]
        self._count(1 + extra, float(n) * self.p
                    * self._x_fast.element_size() + narrow_bytes)
        return mask

    def _gather_dots(self, cols: np.ndarray, rows: torch.Tensor):
        """The float32 dots of ``rows`` with the columns ``cols`` (host
        indices), gathered into a zero-padded bucket of
        :func:`_narrow_bucket` width (replicated on a mesh) and summed as
        the wide float32 pass sums them: ``wide_p`` is the width that pass
        streams, p off a mesh and the rank's p/F on one (the sharded
        backend then runs the tile's pass alone). Returns (dots (R,
        bucket), the gather's bytes)."""
        ws = self.ws
        bucket = _narrow_bucket(int(cols.size), self.p)
        Xn = ws.geometry.columns(cols, bucket)
        dn = ws.backend.matvec(Xn, rows, wide_p=ws.X.shape[1])
        return dn, float(ws.X.shape[0]) * bucket * ws.X.element_size()

    def _retest(self, dec: torch.Tensor, band: torch.Tensor,
                rows: torch.Tensor, decide):
        """Re-test the band's columns in float32 and take their decisions:
        outside the band the bf16 decision is the float32 one, inside it
        the gathered float32 dots are the wide pass's, so the mask is the
        float32 engine's bit for bit. Returns (mask, extra passes, extra
        bytes)."""
        cols = _any_col(band)
        self.last_fallback_cols = int(cols.size)
        if cols.size == 0:
            return dec, 0, 0.0
        dn, nbytes = self._gather_dots(cols, rows)
        idx = torch.from_numpy(cols).to(dec.device)
        dec[:, idx] = decide(dn[:, :cols.size], idx)
        return dec, 1, nbytes


def _any_col(flags: torch.Tensor) -> np.ndarray:
    """The columns (host indices) that any row of a (B, p) bool flags."""
    return np.flatnonzero(flags.cpu().numpy().any(axis=0))


class _Query(NamedTuple):
    """One query of a screen: its row of y, λ and λ_max as host floats,
    its (rank-1) state, its feasibility cut and its λ_max feature."""
    y: torch.Tensor
    lam: float
    lam_max: float
    state: scr.DualState | None
    cut: scr.HalfSpaceCut
    istar: int


def _host_rows(lam) -> np.ndarray:
    """Per-query λ as a float64 host (B,) array (from a tensor, an array or
    a sequence)."""
    if isinstance(lam, torch.Tensor):
        lam = lam.detach().cpu().numpy()
    return np.asarray(lam, dtype=np.float64).reshape(-1)


class GroupDictionaryGeometry(_ColumnGeometry):
    """The query-independent geometry of a fitted *group* dictionary: X,
    the group size m and the per-group spectral norms ‖X_g‖₂ (Theorem 20;
    an m × m eigendecomposition per group, the expensive y-independent
    part of group screening). ``_spec_norms`` adopts a fit made elsewhere
    (``fit_passes`` then stays 0). With ``mesh``, X is the rank's column
    block of whole groups of a global X with ``p`` columns: the spectral
    norms are each rank's groups' gathered
    (:func:`.distributed.group_spectral_norms`); the reads of X are
    :class:`DictionaryGeometry`'s."""

    def __init__(self, X: torch.Tensor, m: int, backend=None, *,
                 _spec_norms=None, mesh=None):
        self.X = X
        self.m = m
        self.mesh = mesh
        self.p = X.shape[1] * (1 if mesh is None else dist.feature_size(mesh))
        self.backend = ops.resolve_backend(backend, X.device)
        self.fit_passes = 0
        self.query_passes = 0
        if _spec_norms is None:
            _spec_norms = (gscr.group_spectral_norms(X, m) if mesh is None
                           else dist.group_spectral_norms(mesh, X, m))
            self.fit_passes = 1
        self.spec_norms = _spec_norms


class GroupScreeningEngine:
    """Group EDPP / group strong screens through the group kernel.

    Caches ‖X_g‖₂ (from the geometry), λ̄_max (one ``group_scores`` pass
    over y) and the λ̄_max ray v̄₁ = X*X*ᵀy once per query; each screen is
    then one ``group_screen_scores`` pass over X. Every read of the
    global X goes through the geometry (the λ̄_max group's columns, Xβ),
    so on a mesh the engine runs on the rank's block."""

    def __init__(self, X, y, m: int, backend=None,
                 eps: float = gscr.EPS_DEFAULT, *,
                 geometry: GroupDictionaryGeometry | None = None):
        if geometry is None:
            geometry = GroupDictionaryGeometry(X, m, backend)
        geometry.query_passes += 1
        self.geometry = geometry
        self.backend = geometry.backend
        self.X = geometry.X
        self.y = y
        self.m = m
        self.eps = eps
        self._state_max = gscr.group_state_at_lambda_max(
            self.X, y, m, scores=self.backend.group_scores,
            columns=geometry.columns)
        self.lam_max = float(self._state_max.lam)
        self.spec_norms = geometry.spec_norms
        self.total_x_passes = 0
        self.last_x_passes = 0
        self.last_screen_bytes = 0.0

    @property
    def backend_name(self) -> str:
        return self.backend.name

    @property
    def p(self) -> int:
        """Columns of the global X (on a mesh, X holds the rank's block)."""
        return self.geometry.p

    def state_at_lambda_max(self) -> gscr.GroupDualState:
        return self._state_max

    def make_state(self, beta, lam: float, *,
                   fitted=None) -> gscr.GroupDualState:
        """The sequential state from the solution at λ, with the λ̄_max
        branch served from the cache. ``fitted`` (= Xβ, from the reduced
        bucket) skips the X·β pass."""
        if scr.at_lmax(lam, self.lam_max):
            return self._state_max
        if fitted is None:
            fitted = self.geometry.fitted(beta)
        return gscr.group_state_from_solution(self.X, self.y, beta, lam,
                                              fitted=fitted)

    def _count(self, passes: int) -> None:
        n = self.X.shape[0]
        self.last_x_passes = passes
        self.total_x_passes += passes
        self.last_screen_bytes = (float(passes) * n * self.p
                                  * self.X.element_size())

    def screen(self, lam_next: float, state: gscr.GroupDualState,
               rule: str = "edpp") -> torch.Tensor:
        """Discard mask bool[G] for λ_next: one pass over X (none for
        ``rule="none"``)."""
        if rule == "none":
            self._count(0)
            return torch.zeros((self.p // self.m,), dtype=torch.bool,
                               device=self.X.device)
        if rule == "strong":
            mask = gscr.group_strong_mask(
                self.X, self.y, lam_next, state, self.m, eps=self.eps,
                scores=self.backend.group_scores)
        elif rule == "edpp":
            mask = gscr.group_edpp_mask(
                self.X, self.y, lam_next, state, self.m,
                spec_norms=self.spec_norms, eps=self.eps,
                scores=self.backend.group_scores)
        else:
            raise ValueError(f"group screens take rules "
                             f"{GROUP_ENGINE_RULES}, got {rule!r}")
        self._count(1)
        return mask
