"""Incremental dictionary updates: fit once, then edit in place.

A dictionary in service churns: items are retired and added. A full
``fit`` on every edit throws away everything the screens reuse, so a
column edit becomes a *plan* applied to the session's fitted state in
place (the reference's ``repro.core.update``, under the same names):

  * :func:`make_plan` validates ``add=`` / ``drop=`` into an
    :class:`UpdatePlan`. The layout rule: added columns first *recycle*
    the dropped slots in ascending drop order, leftover adds append at
    the end, leftover drops compact the survivors left, keeping their
    order. A balanced edit (retire c columns, add c) is pure recycling:
    no column moves, and the update is O(n·c) column patches, not an
    O(n·p) refit.
  * :meth:`~.engine.DictionaryGeometry.apply_update` patches the
    geometry: survivors carry ‖x_j‖², ‖x_j‖, every reduced-precision
    screen copy and its ``:err`` bound untouched; only the added block
    pays fresh passes (the fused ‖x_j‖² pass, the cast, the error
    bound). A shape-changing edit rebuilds them at the new width.
  * :func:`update_workspace` refreshes a live
    :class:`~.engine.PathWorkspace`: for a balanced edit one
    ``screen_matvec`` over the added block patches |Xᵀy| at the recycled
    slots, and λ_max comes from the touched columns against the cached
    argmax, with the full rescan only for a query whose argmax column was
    dropped (ties go to the lower index, as a cold ``argmax``). A
    shape-changing edit attaches the query cold.
  * :func:`carry_mask` maps screening masks across the edit: survivors
    keep their decisions, added columns enter unscreened.

Exactness (the oracle-refit contract): after ``session.update(...)`` and
``session.reset_solver_cache()``, ``path`` gives the masks of a cold
``LassoSession.fit`` on the edited X bit for bit and β within
``beta_err_tol``; the geometry's X, ‖x_j‖², ‖x_j‖, bf16 copy and
``:err``, and a live workspace's |Xᵀy|, argmax and λ_max equal the cold
fit's bit for bit. The reference *probes* each block shape once against
a full-width recompute, because XLA's reduction order depends on the
shape. The port needs no probe: every per-column sum of the carry is
ordered by a plan, not by the shape. On the card the added block's
fused pass and matvec launch with ``wide_p``, the width of the pass that
owns the column (p off a mesh, the rank's p/F on one), so each column is
summed as that pass sums it (``kernels.edpp_screen.retest_plan``); on
the CPU the plain versions sum by a fixed tree (``kernels.ref.
sum_rows``); the error bound sums by that tree on either device.

Mask carry-over is exact when the dropped columns were inactive at the
mask's λ (removing an all-zero coordinate leaves the primal solution,
hence the dual optimum and every sphere built from it, unchanged).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "UpdatePlan",
    "UpdateReport",
    "carry_mask",
    "make_plan",
    "update_workspace",
]


@dataclasses.dataclass(frozen=True, eq=False)
class UpdatePlan:
    """A validated column edit.

    Layout rule (see the module doc): the first
    ``n_recycle = min(n_add, n_drop)`` added columns overwrite the dropped
    slots ``recycle_idx = drop_idx[:n_recycle]`` in place; residual drops
    ``drop_idx[n_recycle:]`` compact the survivors left; residual adds
    (``n_append``) append at the end. ``keep_idx`` lists the *slots*
    that survive compaction (recycled slots included: they survive
    holding new content), so the edited dictionary is
    ``[patched_X[:, keep_idx], X_add[:, n_recycle:]]``.
    """

    p_old: int
    n_add: int
    keep_idx: np.ndarray        # (p_keep,) surviving slots, ascending
    drop_idx: np.ndarray        # sorted unique dropped old columns

    @property
    def n_drop(self) -> int:
        return int(self.drop_idx.size)

    @property
    def n_recycle(self) -> int:
        return min(self.n_add, self.n_drop)

    @property
    def n_append(self) -> int:
        return self.n_add - self.n_recycle

    @property
    def recycle_idx(self) -> np.ndarray:
        """Dropped slots overwritten by the first added columns."""
        return self.drop_idx[:self.n_recycle]

    @property
    def pure_recycle(self) -> bool:
        """No column moves: every add lands in a dropped slot exactly."""
        return self.n_add == self.n_drop

    @property
    def p_new(self) -> int:
        return int(self.keep_idx.size) + self.n_append

    @property
    def recycle_new_idx(self) -> np.ndarray:
        """Edited positions of the recycled slots, ascending."""
        return np.searchsorted(self.keep_idx, self.recycle_idx)

    @property
    def touched_new_idx(self) -> np.ndarray:
        """Edited positions of all added columns, ascending (recycled
        slots, then the appended tail)."""
        p_keep = int(self.keep_idx.size)
        return np.concatenate([
            self.recycle_new_idx,
            np.arange(p_keep, p_keep + self.n_append, dtype=np.int64)])

    def dropped(self, old_idx):
        """Whether the old column(s) content was dropped (a recycled slot
        survives, but its old content is gone)."""
        return np.isin(old_idx, self.drop_idx)

    def new_index(self, old_idx):
        """Old column indices → their edited positions (-1: content
        dropped, recycled slots included)."""
        old = np.asarray(old_idx)
        pos = np.searchsorted(self.keep_idx, old)
        pos = np.clip(pos, 0, max(self.keep_idx.size - 1, 0))
        ok = ((self.keep_idx.size > 0) & (self.keep_idx[pos] == old)
              & ~np.isin(old, self.drop_idx))
        return np.where(ok, pos, -1)


@dataclasses.dataclass(frozen=True)
class UpdateReport:
    """What one ``session.update`` did."""

    version: int                # the session/geometry version after the edit
    p: int                      # edited column count
    n_add: int
    n_drop: int
    geometries_updated: int     # per-backend geometries edited in place
    eig_buckets_carried: int    # warm Lipschitz eigenvectors kept as v0
    workspaces_updated: int     # live query streams refreshed
    argmax_rescans: int         # streams whose λ_max argmax was dropped


def make_plan(p_old: int, add=None, drop=None):
    """Validate an ``add=`` / ``drop=`` edit into ``(UpdatePlan, X_add)``.

    ``drop`` is a sequence of old column indices (deduplicated, order
    irrelevant); ``add`` an (n, p_add) block (a host array or a tensor,
    returned as given; None when it has no columns). Raises
    ``ValueError`` on out-of-range or non-integer drops, a non-2-D add
    block, or an edit that would leave the dictionary empty.
    """
    if add is None and drop is None:
        raise ValueError("update needs add= and/or drop=")
    if drop is None:
        drop_idx = np.zeros(0, dtype=np.int64)
    else:
        drop_idx = np.atleast_1d(np.asarray(drop))
        if drop_idx.ndim != 1:
            raise ValueError(f"drop must be 1-D indices, got shape "
                             f"{drop_idx.shape}")
        if drop_idx.size and not np.issubdtype(drop_idx.dtype, np.integer):
            raise ValueError(f"drop must be integer indices, got dtype "
                             f"{drop_idx.dtype}")
        if drop_idx.size and (
                (drop_idx < 0).any() or (drop_idx >= p_old).any()):
            raise ValueError(f"drop indices out of range for p={p_old}: "
                             f"{drop_idx[(drop_idx < 0) | (drop_idx >= p_old)]}")
        drop_idx = np.unique(drop_idx.astype(np.int64))

    X_add = None
    n_add = 0
    if add is not None:
        X_add = add if isinstance(add, torch.Tensor) else np.asarray(add)
        if X_add.ndim != 2:
            raise ValueError(f"add must be an (n, p_add) block, got shape "
                             f"{tuple(X_add.shape)}")
        n_add = int(X_add.shape[1])
        if n_add == 0:
            X_add = None
    # recycled slots (drop_idx[:min(n_add, n_drop)]) survive compaction:
    # they hold new content, so only the residual drops remove slots
    resid_drop = drop_idx[min(n_add, drop_idx.size):]
    if resid_drop.size:
        keep_idx = np.setdiff1d(np.arange(p_old, dtype=np.int64), resid_drop)
    else:
        keep_idx = np.arange(p_old, dtype=np.int64)
    plan = UpdatePlan(p_old=int(p_old), n_add=n_add,
                      keep_idx=keep_idx, drop_idx=drop_idx)
    if plan.p_new == 0:
        raise ValueError("edit would leave an empty dictionary")
    return plan, X_add


def carry_mask(mask, plan: UpdatePlan) -> np.ndarray:
    """Map (…, p_old) screening masks onto the edited dictionary.

    Surviving columns keep their discard decisions; added columns enter
    unscreened (False = kept), both the appended tail and the recycled
    slots, whose inherited bit belonged to the dropped content. Exact
    when the dropped columns were inactive at the mask's λ (see the
    module doc).
    """
    m = np.asarray(mask)
    kept = np.take(m, plan.keep_idx, axis=-1)
    if plan.n_recycle:
        kept = kept.copy()
        kept[..., plan.recycle_new_idx] = 0
    if plan.n_append:
        pad = np.zeros(m.shape[:-1] + (plan.n_append,), dtype=m.dtype)
        kept = np.concatenate([kept, pad], axis=-1)
    return kept


def update_workspace(ws, plan: UpdatePlan, X_add=None) -> int:
    """Refresh a live :class:`~.engine.PathWorkspace` across a dictionary
    edit. Its geometry must already be at the edited width (the session
    updates geometries first).

    A balanced edit (``plan.pure_recycle``) keeps every survivor's
    |x_jᵀy| (a column's dot depends on its own column alone) and patches
    the recycled slots with one ``screen_matvec`` over the added block,
    launched with the width of the pass that owns the columns
    (``wide_p``: p off a mesh, p/F on one), so the patched values are the
    cold attach's bits. λ_max then comes from the touched columns against
    the cached argmax; a query whose argmax column was dropped rescans
    its whole row. A shape-changing edit attaches the query cold (one
    pass over X). Either way v₁ and the λ_max cut come from the argmax
    column by the cold attach's own function.

    Returns the number of queries whose cached argmax column content was
    dropped (:class:`UpdateReport` ``argmax_rescans``).
    """
    geom = ws.geometry
    if geom.p != plan.p_new:
        raise ValueError(
            f"workspace geometry has p={geom.p} but the plan edits to "
            f"p={plan.p_new}: update the geometry first")
    n_dropped_argmax = int(np.sum(plan.dropped(np.asarray(ws.istar))))
    if not plan.pure_recycle:
        ws.attach()
        return n_dropped_argmax
    if plan.n_add == 0:
        return n_dropped_argmax

    touched = plan.touched_new_idx        # ascending: the lowest wins ties
    add = torch.as_tensor(X_add, dtype=geom.X.dtype,
                          device=geom.X.device).contiguous()
    scores_add = torch.abs(geom.backend.matvec(add, ws.y,
                                               wide_p=geom.X.shape[1]))
    geom.update_passes += 1
    idx = torch.from_numpy(touched).to(geom.X.device)
    abs_xty = ws.abs_xty.clone()
    abs_xty.index_copy_(-1, idx, scores_add)
    ws.abs_xty = abs_xty

    if ws.batch is None:
        if plan.dropped(ws.istar):
            istar = int(torch.argmax(abs_xty))
        else:
            istar = int(ws.istar)         # pure recycle: slots do not move
            st = scores_add.cpu().numpy()
            jt = int(touched[int(np.argmax(st))])
            si, sj = float(abs_xty[istar]), float(st.max())
            # a cold argmax breaks ties toward the lower index, and a
            # recycled slot can sit below the surviving argmax
            if sj > si or (sj == si and jt < istar):
                istar = jt
        ws.set_argmax(istar)
        return n_dropped_argmax

    rows = np.arange(ws.batch)
    old = np.asarray(ws.istar)
    dropped = plan.dropped(old)
    st = scores_add.cpu().numpy()                       # (B, n_add)
    jt = touched[st.argmax(axis=-1)]
    sj = st[rows, st.argmax(axis=-1)]
    si = abs_xty.gather(1, torch.from_numpy(old).to(abs_xty.device)[:, None]
                        )[:, 0].cpu().numpy()
    take_add = (sj > si) | ((sj == si) & (jt < old))
    istar = np.where(take_add, jt, old)
    if dropped.any():
        istar = np.where(dropped, torch.argmax(abs_xty, dim=-1).cpu().numpy(),
                         istar)
    ws.set_argmax(istar)
    return n_dropped_argmax
