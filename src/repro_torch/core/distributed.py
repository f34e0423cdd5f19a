"""Feature-sharded EDPP screening and Lasso solving over ``torch.distributed``.

The layout is the reference's 2-D mesh: a
:class:`~torch.distributed.device_mesh.DeviceMesh` with named axes, where
the axis ``"query"`` carries query batches and every other axis is a
feature axis. X (n × p) is split by columns over the feature axis; y and
every dual-geometry n-vector are replicated. Then

  * screening scores |x_jᵀc| + ρ‖x_j‖ are local to each column block:
    no communication;
  * λ_max and ‖Xᵀr‖_∞ take one scalar MAX all-reduce;
  * the fit Xβ takes one SUM all-reduce of an n-vector per solver
    iteration, over the feature group only.

For the ``dist_*`` ops a batch of B queries is split over the ``query``
axis when B divides its size (replicated otherwise), so the recurring
collective is one (B_local, n) all-reduce per query shard. A mesh
*session* keeps a (B, n) batch whole on every rank instead: each rank
screens the batch on its column block (one batched ``screen_matvec``
launch and one all-gather a step), gathers the union bucket replicated
and solves the whole batch, so every rank returns the whole batch's
``PathResult``, equal to the unsharded session's. Ranks along the query
axis repeat the same work; splitting the batch over them is left for
the serving loop (ROADMAP.md queue 1 item 12).

**One process per rank.** The reference is single-controller: its
functions take and return global arrays whose columns JAX shards. Here
every rank calls with the same global host arrays, the ``place_*``
helpers keep the rank's part, and the ``dist_*`` functions take and
return the rank's local blocks (what the reference's ``shard_map``
bodies see): X (n, p/F), β (p/F,) or (B_local, p/F), per-query arrays
(B_local, ...). :func:`gather_features` and :func:`gather_queries`
rebuild global arrays in global order. p must be divisible by the
feature size F.

**Kernels.** The per-shard tile work runs the tile backend's kernels of
:mod:`repro_torch.kernels.ops` on the local block: ``matvec`` and
``fused_scores`` in the screens, ``lambda_max_d``, ``sup_corr_d`` and
the power iteration; ``fista_step`` in :func:`dist_fista` (``"none"``)
and :func:`dist_fista_batched`; ``prox_step`` in :func:`dist_fista`
(``"chunked"``, ``"stale"``; in ``"chunked"`` it also sums the gradient's
per-chunk parts). The forward fits ``X_b @ z`` and the chunked gradient's
parts are plain matrix products (``torch.matmul``), as the reference
leaves them to XLA. On the card :func:`dist_fista` replays its
iterations, collectives included, from CUDA graphs
(:mod:`repro_torch.core.graphs`), as the reference runs them as one
``lax.scan``. :func:`sharded_backend` packages the
screening dispatch as a backend (``"shard:<tile>"``) whose outputs come
back gathered in global column order; ``LassoSession.fit(X, mesh=...)``
drops it into the unsharded engines.

**Feature axes.** Every axis other than ``"query"`` is a feature axis,
and together they form one logical feature axis, as in the reference:
its ranks are those of the sub-mesh over the feature axes, row-major in
the mesh's axis order (the column order of the reference's
``P(feature_axes)``), and one process group made per mesh with
``torch.distributed.new_group`` carries its collectives, so a
``("query", "a", "b")`` mesh of shape (Q, A, B) is a (Q, A·B) mesh.

**Group Lasso.** A group mesh session (``fit(X, groups=m, mesh=)``)
needs blocks of whole groups (m divides p/F): the sharded backend's
``group_scores`` runs the group pass on the block with the global width
as ``wide_p`` and gathers the scores, and :func:`group_spectral_norms`
gathers each block's ‖X_g‖₂.

The reference's GSPMD baseline ``pjit_screen`` has no counterpart here:
it leaves the layout to XLA's partitioner, which PyTorch has only in
DTensor (ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch
import torch.distributed as dist

from .. import pshard
from ..kernels import ops
from . import graphs
from . import group_screening as gscr
from . import screening as scr
from .device import as_tensor
from .screening import EPS_DEFAULT
from .solver import fista_momentum, fista_step_size, host_float

#: Mesh axis carrying query batches; every other axis is a feature axis.
QUERY_AXIS = "query"


def _names(mesh) -> tuple[str, ...]:
    if not mesh.mesh_dim_names:
        raise ValueError("the mesh needs named axes, e.g. init_device_mesh("
                         "..., mesh_dim_names=('query', 'feature'))")
    return tuple(mesh.mesh_dim_names)


def query_axes(mesh) -> tuple[str, ...]:
    """The mesh's query axes: () or (``QUERY_AXIS``,)."""
    return tuple(a for a in _names(mesh) if a == QUERY_AXIS)


def feature_axes(mesh) -> tuple[str, ...]:
    """Every non-query axis; together they form one logical feature axis."""
    return tuple(a for a in _names(mesh) if a != QUERY_AXIS)


def _size(mesh, axes) -> int:
    names = _names(mesh)
    return int(np.prod([mesh.size(names.index(a)) for a in axes], initial=1))


def query_size(mesh) -> int:
    """Ranks along the query axis (1 if the mesh has none)."""
    return _size(mesh, query_axes(mesh))


def feature_size(mesh) -> int:
    """Ranks along the feature axes: the number of column blocks of X."""
    return _size(mesh, feature_axes(mesh))


def _axis(mesh, axes):
    """(group, size, this rank's index, group ranks in axis order) of the
    logical axis made of ``axes``; (None, 1, 0, (0,)) when the mesh has
    none of them. An axis of size 1 keeps its group, so its collectives
    run (as exact copies). Several axes are flattened into one
    (:func:`_flat_axis`)."""
    if not axes:
        return None, 1, 0, (0,)
    if len(axes) > 1:
        return _flat_axis(mesh, axes)
    name = axes[0]
    dim = _names(mesh).index(name)
    group = mesh.get_group(name)
    where = list(mesh.get_coordinate())
    where[dim] = slice(None)
    ranks = pshard.rank_table(mesh)[tuple(where)].tolist()
    order = tuple(dist.get_group_rank(group, r) for r in ranks)
    return group, len(ranks), mesh.get_local_rank(name), order


# The flattened axes' groups, per mesh: {id(mesh): (weakref to the mesh,
# axes, the axis tuple)}. A mesh is keyed by identity, not equality: a
# new mesh of the same shape under a new process group must not reuse a
# destroyed group.
_FLAT_AXES: dict[int, tuple] = {}


def _flat_axis(mesh, axes):
    """:func:`_axis` of several axes taken as one logical axis: the ranks
    of the sub-mesh over ``axes`` (the other axes fixed at this rank's
    coordinate), row-major in the mesh's axis order, which is the column
    order of the reference's ``P(feature_axes)``. Its process group is
    made once per mesh with ``torch.distributed.new_group``, one for
    every sub-mesh, by every rank in the same order (``new_group`` is
    collective over the whole world), and cached."""
    key = id(mesh)
    hit = _FLAT_AXES.get(key)
    if hit is not None and hit[0]() is mesh and hit[1] == axes:
        return hit[2]
    names = _names(mesh)
    dims = [names.index(a) for a in axes]
    rest = [d for d in range(len(names)) if d not in dims]
    size = _size(mesh, axes)
    rows = pshard.rank_table(mesh).transpose(*rest, *dims).reshape(
        -1, size).tolist()
    me = dist.get_rank()
    axis = None
    for ranks in rows:                    # every rank makes every group
        group = dist.new_group(ranks=ranks)
        if me in ranks:
            order = tuple(dist.get_group_rank(group, r) for r in ranks)
            axis = (group, size, ranks.index(me), order)
    if axis is None:
        raise ValueError(f"rank {me} is not in the mesh {mesh}")
    _FLAT_AXES[key] = (weakref.ref(mesh), axes, axis)
    return axis


def _feature(mesh):
    return _axis(mesh, feature_axes(mesh))


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on: its current CUDA device on
    a ``"cuda"`` mesh, the CPU on a ``"cpu"`` one."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def feature_range(mesh, p: int) -> tuple[int, int]:
    """The global columns [lo, hi) of this rank's block of a width-p
    array; ``ValueError`` unless the feature size divides p."""
    _, size, index, _ = _feature(mesh)
    if p % size:
        raise ValueError(f"p={p} is not divisible by the mesh's feature "
                         f"size {size}: pad X with zero columns to a "
                         f"multiple of {size}")
    width = p // size
    return index * width, (index + 1) * width


# ---------------------------------------------------------------------------
# Collectives over the feature (or query) group; identity where the mesh
# has no such axis
# ---------------------------------------------------------------------------

def _reduce(x: torch.Tensor, group, op, async_op: bool = False):
    """All-reduce ``x`` in place over ``group`` (a fresh tensor: callers
    pass results they own)."""
    if group is None:
        return None if async_op else x
    work = dist.all_reduce(x, op=op, group=group, async_op=async_op)
    return work if async_op else x


def _psum(mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum over the feature axes (in place)."""
    return _reduce(x, _feature(mesh)[0], dist.ReduceOp.SUM)


def _pmax(mesh, x: torch.Tensor) -> torch.Tensor:
    """Max over the feature axes (in place)."""
    return _reduce(x, _feature(mesh)[0], dist.ReduceOp.MAX)


def _gather(local: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """All-gather ``local`` over ``axis`` and concatenate the parts in axis
    order along ``dim``. bfloat16 travels as its bytes (a uint8 view of
    the last axis: exact; gloo gathers neither bfloat16 nor int16)."""
    group, size, _, order = axis
    if group is None:
        return local
    bf16 = local.dtype == torch.bfloat16
    local = local.contiguous()
    if bf16:
        local = local.view(torch.uint8)
    parts = [torch.empty_like(local) for _ in range(size)]
    dist.all_gather(parts, local, group=group)
    whole = torch.cat([parts[r] for r in order], dim=dim)
    return whole.view(torch.bfloat16) if bf16 else whole


def gather_features(mesh, local: torch.Tensor) -> torch.Tensor:
    """The global (..., p) array from every rank's (..., p/F) block, in
    global column order, on every rank of the feature group."""
    return _gather(local, _feature(mesh), -1)


def gather_queries(mesh, local: torch.Tensor, batch: int) -> torch.Tensor:
    """The global (B, ...) array from every rank's query block, when the
    batch of ``batch`` queries was split over the query axis (else the
    local array is already whole)."""
    axis = _axis(mesh, query_axes(mesh))
    if batch % axis[1]:
        return local
    return _gather(local, axis, 0)


def gather_columns(mesh, X: torch.Tensor, cols, width: int | None = None
                   ) -> torch.Tensor:
    """Columns ``cols`` (global indices, a host sequence) of the global X,
    as an (n, width) block zero-padded past ``len(cols)``, the same on
    every rank of the feature group, from each rank's block X (n, p/F).

    Every rank knows ``cols``, so each knows how many columns every rank
    owns: each contributes its own, padded to the largest count, one
    all-gather brings them together, and they are put back in the order
    of ``cols``. Values are copied, never recomputed."""
    cols = np.asarray(cols, dtype=np.int64)
    width = cols.size if width is None else width
    n, p_local = X.shape
    axis = _feature(mesh)
    size, index = axis[1], axis[2]
    owner, local = np.divmod(cols, p_local)
    counts = np.bincount(owner, minlength=size)
    order = np.argsort(owner, kind="stable")
    starts = np.cumsum(counts) - counts
    slot = np.empty_like(cols)          # position among its owner's columns
    slot[order] = np.arange(cols.size) - starts[owner[order]]
    common = int(counts.max())
    mine = torch.from_numpy(local[owner == index]).to(X.device)
    part = torch.zeros((n, common), dtype=X.dtype, device=X.device)
    part[:, :mine.numel()] = X.index_select(1, mine)
    whole = _gather(part, axis, 1)                     # (n, F·common)
    out = torch.zeros((n, width), dtype=X.dtype, device=X.device)
    pick = torch.from_numpy(owner * common + slot).to(X.device)
    out[:, :cols.size] = whole.index_select(1, pick)
    return out


def relayout_columns(mesh, X: torch.Tensor, cols, p_new: int):
    """This rank's block of a new global layout of width ``p_new`` whose
    first ``len(cols)`` columns are the global columns ``cols`` of the
    old X (each rank's block X (n, p/F)); the block's columns past them
    are zero, for the caller to fill (a dictionary update's appended
    columns). One :func:`gather_columns` a destination rank whose new
    range takes old columns, each the same call on every rank, so a rank
    holds its old block, one destination block and its own new block,
    never the whole X. Returns (the block, the bytes this rank received
    in the gathers)."""
    cols = np.asarray(cols, dtype=np.int64)
    n, p_local = X.shape
    _, size, index, _ = _feature(mesh)
    lo, hi = feature_range(mesh, p_new)
    width = hi - lo
    mine = torch.zeros((n, width), dtype=X.dtype, device=X.device)
    received = 0.0
    for d in range(size):
        part = cols[d * width:min((d + 1) * width, cols.size)]
        if part.size == 0:
            continue
        common = int(np.bincount(part // p_local, minlength=size).max())
        received += float(size * n * common * X.element_size())
        block = gather_columns(mesh, X, part)
        if d == index:
            mine[:, :part.size] = block
    return mine, received


def fitted_values(mesh, X: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Xβ (n,) for a global β (p,), or βXᵀ (B, n) for β (B, p),
    replicated: one all-reduce of the n-vectors."""
    lo, hi = feature_range(mesh, beta.shape[-1])
    local = beta[..., lo:hi]
    return _psum(mesh, local @ X.T if beta.dim() == 2 else X @ local)


# ---------------------------------------------------------------------------
# Placement: every rank holds the same global host arrays
# ---------------------------------------------------------------------------

def place_dictionary(mesh, X, device=None) -> torch.Tensor:
    """This rank's contiguous column block of the global X (n, p), on
    ``device`` (default: the mesh's). ``ValueError`` unless the mesh's
    feature size divides p."""
    lo, hi = feature_range(mesh, X.shape[-1])
    return as_tensor(X[:, lo:hi], device or mesh_device(mesh))


def place_features(mesh, a, device=None) -> torch.Tensor:
    """This rank's block of the last (feature) axis of a global (..., p)
    array: β, ‖x_j‖, scores."""
    lo, hi = feature_range(mesh, a.shape[-1])
    return as_tensor(a[..., lo:hi], device or mesh_device(mesh))


def place_queries(mesh, a, device=None, *, batched: bool | None = None
                  ) -> torch.Tensor:
    """This rank's rows of a per-query array when its leading batch axis
    B is divisible by the query size, else all of it. ``batched`` (default:
    ``a.ndim == 2``) says whether the leading axis is a batch: a single
    y (n,) is replicated, a λ vector (B,) needs ``batched=True``."""
    t = as_tensor(a, device or mesh_device(mesh))
    batched = t.dim() == 2 if batched is None else batched
    _, size, index, _ = _axis(mesh, query_axes(mesh))
    if not batched or t.shape[0] % size:
        return t
    rows = t.shape[0] // size
    return t[index * rows:(index + 1) * rows].contiguous()


def shard_problem(mesh, X, y, device=None):
    """(X's column block, y replicated or query-split) on the mesh."""
    return (place_dictionary(mesh, X, device),
            place_queries(mesh, y, device))


# ---------------------------------------------------------------------------
# Per-shard backend dispatch
# ---------------------------------------------------------------------------

def _tile(mesh, backend) -> ops.ScreenBackend:
    return ops.resolve_backend(backend, mesh.device_type)


def sharded_backend(mesh, tile=None) -> ops.ScreenBackend:
    """A :class:`~repro_torch.kernels.ops.ScreenBackend` named
    ``"shard:<tile>"`` whose screening ops run ``tile``'s kernels on the
    rank's column block and gather the result in global column order:

    * ``matvec(X_b, centre)``: the block's dots, one all-gather;
    * ``fused_scores(X_b, centre, ρ)``: scores and ‖x_j‖² of the block,
      one all-gather for both;
    * with ``wide_p``, the tile's pass alone, each column summed as a
      pass over ``wide_p`` columns sums it, no gather: the caller's X is
      a replicated block of global columns (a float32 re-test's gather,
      a dictionary update's added block, with ``wide_p`` = p/F) or the
      rank's block read as the unsharded X (the KKT check's Xᵀr, with
      ``wide_p`` = p, gathered by the geometry);
    * ``group_scores(X_b, centre, m)``: the tile's group pass on the
      block of whole groups, launched with ``wide_p`` = p (the global
      width: each group is summed as the unsharded pass sums it), one
      all-gather into global group order.

    The solver ops pass through to the tile unchanged: the path's reduced
    buckets come replicated (``DictionaryGeometry.columns``), so they run
    on whole arrays. ``tile`` is a backend name, a ScreenBackend, or None
    (follow the mesh's device)."""
    tile = _tile(mesh, tile)

    def matvec(X, centre, wide_p=None):
        if wide_p is not None:
            return tile.matvec(X, centre, wide_p=wide_p)
        return gather_features(mesh, tile.matvec(X, centre))

    def fused_scores(X, centre, rho, wide_p=None):
        if wide_p is not None:
            return tile.fused_scores(X, centre, rho, wide_p=wide_p)
        scores, sumsq = tile.fused_scores(X, centre, rho)
        p_local = sumsq.shape[0]
        both = gather_features(mesh, torch.cat(
            [scores.reshape(-1, p_local), sumsq[None]]))
        return both[:-1].reshape(*scores.shape[:-1], -1), both[-1]

    def group_scores(X, centre, m):
        p = X.shape[1] * feature_size(mesh)
        return gather_features(mesh, tile.group_scores(X, centre, m,
                                                       wide_p=p))

    return ops.ScreenBackend(
        name=f"shard:{tile.name}", matvec=matvec, fused_scores=fused_scores,
        fista_step=tile.fista_step, group_scores=group_scores,
        cd_gram_sweep=tile.cd_gram_sweep, prox_step=tile.prox_step)


def group_spectral_norms(mesh, X: torch.Tensor, m: int) -> torch.Tensor:
    """‖X_g‖₂ of every group (G,), the same on every rank: each rank
    takes its block's groups (``group_screening.group_spectral_norms``:
    one batched ``eigvalsh`` of the block's m × m Grams) and one
    all-gather puts them in global group order. ``ValueError`` unless m
    divides the block's width."""
    check_groups(mesh, X.shape[1] * feature_size(mesh), m)
    return gather_features(mesh, gscr.group_spectral_norms(X, m))


def check_groups(mesh, p: int, m: int) -> None:
    """``ValueError`` unless the rank's block of a width-p X holds whole
    groups of m columns (m divides p/F, and F divides p)."""
    fsize = feature_size(mesh)
    if p % fsize or (p // fsize) % m:
        raise ValueError(
            f"groups of m={m} columns do not split over the mesh: p={p} "
            f"over the feature size F={fsize} gives blocks of "
            f"{p / fsize:g} columns, and m must divide p/F (pad X with "
            f"zero groups to a multiple of F·m={fsize * m})")


def make_dist_ops(mesh, backend=None):
    """The distributed op suite on local blocks, each with the collectives
    its docstring names; the local matvecs run ``backend``'s (or the mesh
    device's) ``screen_matvec`` / ``edpp_screen_scores`` kernels.

    Returns ``(lambda_max_d, matvec_d, screen_scores_d, sup_corr_d)``."""
    tile = _tile(mesh, backend)

    def lambda_max_d(Xb, y):
        """λ_max = max_j |x_jᵀy|. Collectives: one scalar MAX."""
        return _pmax(mesh, torch.max(torch.abs(tile.matvec(Xb, y))))

    def matvec_d(Xb, bb, y):
        """r = y − Xβ. Collectives: one n-vector SUM."""
        return y - _psum(mesh, Xb @ bb)

    def screen_scores_d(Xb, centre, rho, eps=EPS_DEFAULT):
        """EDPP scores and the discard mask of the local block, in one
        fused pass. No collective."""
        scores, _ = tile.fused_scores(Xb, centre, rho)
        return scores, scores < 1.0 - eps

    def sup_corr_d(Xb, r):
        """‖Xᵀr‖_∞. Collectives: one scalar MAX."""
        return _pmax(mesh, torch.max(torch.abs(tile.matvec(Xb, r))))

    return lambda_max_d, matvec_d, screen_scores_d, sup_corr_d


def _edpp_ball(y, lam_next, lam_prev, r, lam_max_val, v1_at_lmax):
    """The EDPP sphere (Corollary 17) from the residual r = y − Xβ at
    λ_prev: θ = r/λ_prev, v₁ from the λ_max cache where λ_prev is at
    λ_max (compared in float32), else y/λ_prev − θ. A single query takes
    host λ's and the engine's arithmetic, so from the same residual it
    builds the engine's ball bit for bit; a batch carries (B,) λ's and
    (B, n) y, r, v₁."""
    if y.dim() == 2:
        def col(v):
            return torch.as_tensor(v, dtype=y.dtype, device=y.device)[:, None]

        lp = col(lam_prev)
        theta = r / lp
        at_max = lp >= col(lam_max_val) * (1.0 - 1e-12)
        v1 = torch.where(at_max, v1_at_lmax, y / lp - theta)
        lam_next = col(lam_next)[:, 0]
    else:
        lam_prev = float(lam_prev)
        theta = r / lam_prev
        at_max = scr.at_lmax(lam_prev, float(lam_max_val))
        v1 = v1_at_lmax if at_max else y / lam_prev - theta
        lam_next = float(lam_next)
    state = scr.DualState(theta=theta, lam=lam_prev, v1=v1, at_lmax=at_max)
    return scr.edpp_sphere(y, lam_next, state)


def dist_edpp_screen(mesh, X, y, lam_next, lam_prev, beta_prev, lam_max_val,
                     v1_at_lmax, eps: float = EPS_DEFAULT, backend=None):
    """The sequential EDPP screen (Corollary 17) on local blocks: the dual
    geometry (θ, v₁, v₂⊥) replicated from one n-vector SUM for the
    residual, then one fused ``edpp_screen_scores`` pass per block.
    ``v1_at_lmax`` is sign(x*ᵀy)·x* (eq. 17).

    Returns (discard mask, scores) of the local block."""
    _, matvec_d, screen_scores_d, _ = make_dist_ops(mesh, backend)
    test = _edpp_ball(y, lam_next, lam_prev, matvec_d(X, beta_prev, y),
                      lam_max_val, v1_at_lmax)
    scores, mask = screen_scores_d(X, test.centre, test.rho, eps)
    return mask, scores


def _cached_scores(tile, X, test, col_norms, eps):
    """(scores, mask) of the local block from one matvec pass and the
    cached norms, in the engine's arithmetic."""
    scores = torch.abs(tile.matvec(X, test.centre)) \
        + (test.rho[:, None] if test.rho.dim() else test.rho) * col_norms
    return scores, scores < 1.0 - eps


def dist_edpp_screen_cached(mesh, X, y, lam_next, lam_prev, beta_prev,
                            lam_max_val, v1_at_lmax, col_norms,
                            eps: float = EPS_DEFAULT, backend=None):
    """Sequential EDPP with the cached column norms of the local block
    (λ-independent): the residual SUM, then one ``screen_matvec`` pass per
    block. Returns (scores, discard mask) of the local block, in the
    reference's order for this function."""
    _, matvec_d, _, _ = make_dist_ops(mesh, backend)
    test = _edpp_ball(y, lam_next, lam_prev, matvec_d(X, beta_prev, y),
                      lam_max_val, v1_at_lmax)
    return _cached_scores(_tile(mesh, backend), X, test, col_norms, eps)


def dist_edpp_screen_sparse(mesh, X, X_active, y, lam_next, lam_prev,
                            beta_active, lam_max_val, v1_at_lmax, col_norms,
                            eps: float = EPS_DEFAULT, backend=None):
    """Sequential EDPP whose residual needs only the active columns: the
    fit runs over each rank's active block X_active (n, p_a/F) with its
    β_active, one n-vector SUM, and the score pass streams the whole
    local block once. Returns (scores, discard mask) of the local block,
    in the reference's order for this function."""
    r = y - _psum(mesh, X_active @ beta_active)
    test = _edpp_ball(y, lam_next, lam_prev, r, lam_max_val, v1_at_lmax)
    return _cached_scores(_tile(mesh, backend), X, test, col_norms, eps)


def dist_edpp_screen_batched(mesh, X, Y, lam_next, lam_prev, beta_prev,
                             lam_max_val, v1_at_lmax, col_norms,
                             eps: float = EPS_DEFAULT, backend=None):
    """Sequential EDPP for the rank's B_local queries, cached norms:
    Y (B_local, n), β_prev (B_local, p/F), λ_next/λ_prev/λ_max (B_local,),
    v₁ (B_local, n). Two passes over the block for the whole batch: one
    (B_local, n) SUM for the residuals, one batched ``screen_matvec``.

    Returns (discard mask, scores), each (B_local, p/F)."""
    R = Y - _psum(mesh, beta_prev @ X.T)
    test = _edpp_ball(Y, lam_next, lam_prev, R, lam_max_val, v1_at_lmax)
    scores, mask = _cached_scores(_tile(mesh, backend), X, test, col_norms,
                                  eps)
    return mask, scores


def dist_fista_batched(mesh, X, Y, lam, beta0, lipschitz, *, iters: int = 200,
                       solver_backend=None):
    """FISTA over the rank's B_local queries on its column block, a fixed
    number of iterations: per iteration one (B_local, n) SUM of the fits
    Z X_bᵀ, then the backend's fused ``fista_step`` kernel (gradient, prox
    and momentum) on the block with per-query λ (scalar or (B_local,)).
    Returns β (B_local, p/F)."""
    fista_op = ops.resolve_backend(solver_backend, X.device).fista_step
    fl = host_float(X)
    step = fista_step_size(lipschitz, fl)
    group = _feature(mesh)[0]
    beta, z, t = beta0, beta0, fl(1.0)
    for _ in range(iters):
        XZ = _reduce(z @ X.T, group, dist.ReduceOp.SUM)
        t, mom = fista_momentum(t, fl)
        beta, z = fista_op(X, XZ - Y, z, beta, step, lam, mom)
    return beta


def dist_power_iteration(mesh, X, iters: int = 30, backend=None
                         ) -> torch.Tensor:
    """‖X‖₂² by power iteration on the column blocks: per iteration one
    n-vector SUM for u = Xv, the block's w = Xᵀu by the backend's
    ``screen_matvec`` kernel, one scalar SUM for ‖w‖; then the Rayleigh
    quotient ‖Xv‖² (at most ‖X‖₂²). The start is a fixed N(0, 1/p) draw
    (a CPU generator seeded 0, as the reference's ``PRNGKey(0)``), the
    same on every rank. Returns a 0-d tensor."""
    tile = _tile(mesh, backend)
    p = X.shape[1] * feature_size(mesh)
    v0 = torch.randn(p, generator=torch.Generator().manual_seed(0),
                     dtype=X.dtype) / np.sqrt(p)
    v = place_features(mesh, v0, X.device)
    for _ in range(iters):
        u = _psum(mesh, X @ v)
        w = tile.matvec(X, u).to(X.dtype)
        nrm = torch.sqrt(_psum(mesh, torch.sum(w * w).reshape(1)))[0]
        v = w / (nrm + 1e-30)
    u = _psum(mesh, X @ v)
    return torch.sum(u * u)


OVERLAP_MODES = ("none", "chunked", "stale")


def dist_fista(mesh, X, y, lam, beta0, lipschitz, *, iters: int = 200,
               overlap: str = "none", n_chunks: int = 4,
               solver_backend=None, capture: bool = True) -> torch.Tensor:
    """Feature-sharded FISTA on the rank's column block X (n, p/F) from
    β0 (p/F,), a fixed number of iterations; returns the block of β.

    Per iteration one n-vector SUM of the fit, local work otherwise,
    through the solver backend's kernels (``solver_backend``: a name, a
    ScreenBackend, or None to follow X's device). Collective modes:

    * ``"none"``: one SUM of X_b z, then the backend's fused
      ``fista_step`` kernel (gradient, prox, momentum) on the block.
    * ``"chunked"``: the rows split into ``n_chunks`` (at most
      ``MAX_PARTS`` = 8 on the card); each chunk's fit is all-reduced
      asynchronously, all at once, and each chunk's gradient part
      X_cᵀ(X_c z − y_c) is taken as its reduction lands, into row c of
      one (chunks, p/F) buffer, so the collectives overlap the local
      products. The backend's ``prox_step`` kernel sums the parts in
      chunk order (the reference's ``functools.reduce(jnp.add, parts)``,
      bit for bit) and applies the prox. Exact, up to the order of the
      gradient sums.
    * ``"stale"``: the gradient from the previous iterate's fit. Hides the
      collective but breaks FISTA's momentum contraction: it oscillates
      instead of converging (kept for the record, as in the reference).

    Each iteration reads its step | λ | mom from a row of one parameter
    table (:func:`~repro_torch.core.graphs.param_table`). On a CUDA X the
    iterations are replayed from a CUDA graph in blocks
    (:func:`~repro_torch.core.graphs.run_loop`), collectives included;
    ``capture=False`` runs the same iterations one launch at a time, with
    the same bits. A CPU X runs them eagerly.
    """
    if overlap not in OVERLAP_MODES:
        raise ValueError(f"overlap must be one of {OVERLAP_MODES}, got "
                         f"{overlap!r}")
    backend = ops.resolve_backend(solver_backend, X.device)
    step = fista_step_size(lipschitz, host_float(X))
    batch = 1 if beta0.dim() == 1 else beta0.shape[0]
    table = graphs.param_table(iters, step, lam, batch, X)
    group = _feature(mesh)[0]
    state = (beta0, beta0)

    def fit(z):
        return _reduce(X @ z, group, dist.ReduceOp.SUM)

    if overlap == "none":
        def body(state, par):
            beta, z = state
            return backend.fista_step(X, fit(z) - y, z, beta, params=par)
    elif overlap == "chunked":
        n = X.shape[0]
        chunk = -(-n // n_chunks)
        bounds = [(lo, min(n, lo + chunk)) for lo in range(0, n, chunk)]
        parts = torch.empty((len(bounds), *beta0.shape), dtype=X.dtype,
                            device=X.device)

        def body(state, par):
            beta, z = state
            fits = [X[lo:hi] @ z for lo, hi in bounds]
            works = [_reduce(f, group, dist.ReduceOp.SUM, async_op=True)
                     for f in fits]
            for c, ((lo, hi), f, work) in enumerate(zip(bounds, fits, works)):
                if work is not None:
                    work.wait()
                torch.matmul(X[lo:hi].T, f - y[lo:hi], out=parts[c])
            return backend.prox_step(z, parts, beta, params=par)
    else:
        def body(state, par):
            beta, z, Xz = state
            Xz_next = fit(z)
            beta, z = backend.prox_step(z, X.T @ (Xz - y), beta, params=par)
            return beta, z, Xz_next
        state += (y - (y - fit(beta0)),)     # X·β₀, as the reference
    return graphs.run_loop(body, state, table, capture=capture)[0]
