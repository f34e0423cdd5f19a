"""The paper's synthetic problems, numpy only: the §4.1.2 Lasso problems
(eq. 74), the §4.2 group-Lasso problems, :class:`QueryStream`, a
deterministic stream of Lasso queries against one fixed dictionary, and
:class:`SyntheticLM`, the LM stack's deterministic token stream.

A copy of ``SyntheticLM``, ``design_matrix``, ``lasso_problem``,
``_cached_design``, ``QueryStream`` and ``group_lasso_problem`` from the
reference's ``data/pipeline.py``: the same seed gives the same arrays, so
both packages can be fed identical problems and batches.
:func:`to_device` takes the place of the reference's ``device_batch``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """A deterministic LM batch stream: batch content is a pure function
    of (seed, step, host shard), so a replacement worker regenerates the
    lost worker's shard exactly."""

    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    frontend: str = "tokens"
    d_frame: int = 512
    d_patch: int = 1024
    n_img_tokens: int = 256

    def host_batch(self, step: int, shard: int = 0, n_shards: int = 1):
        """Numpy batch for (step, host shard): tokens/labels (int32), or
        frames, or tokens with image embeddings, by frontend."""
        b = self.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        if self.frontend == "tokens":
            toks = rng.integers(0, self.vocab, (b, self.seq + 1),
                                dtype=np.int32)
            return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.frontend == "frames":
            return {
                "frames": rng.standard_normal(
                    (b, self.seq, self.d_frame)).astype(np.float32),
                "labels": rng.integers(0, self.vocab, (b, self.seq),
                                       dtype=np.int32),
            }
        if self.frontend == "vlm":
            st = self.seq - self.n_img_tokens
            toks = rng.integers(0, self.vocab, (b, st + 1), dtype=np.int32)
            return {
                "tokens": toks[:, :-1],
                "image_embeds": rng.standard_normal(
                    (b, self.n_img_tokens, self.d_patch)).astype(np.float32),
                "labels": toks[:, 1:],
            }
        raise ValueError(self.frontend)


def to_device(host_batch: dict, device) -> dict:
    """A host batch as tensors on ``device`` (the reference's
    ``device_batch`` on one device)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host_batch.items()}


def device_batch(mesh, host_batch: dict, accum_steps: int = 1) -> dict:
    """The rank's rows of a global host batch, on the mesh's device: the
    reference's ``device_batch`` (``pipeline.py:190-198``) for one process
    per rank. Every rank passes the same global batch (``SyntheticLM.
    host_batch(step)``: its ``shard`` argument draws other rows, not a
    slice of the global batch) and keeps the rows its coordinate on the
    batch axes selects (:func:`repro_torch.pshard.batch_spec`, degraded
    for the rows' count). With ``accum_steps`` > 1 each microbatch (a
    block of consecutive global rows, as the reference's step splits
    them) is cut alike and the rank's parts are stacked in order, the
    layout :func:`repro_torch.train.steps.make_train_step` reads."""
    from ..core.distributed import mesh_device
    from ..pshard import Layout, batch_spec
    dev = mesh_device(mesh)
    out = {}
    for k, v in host_batch.items():
        micros = np.asarray(v).reshape(accum_steps, -1, *np.shape(v)[1:])
        lay = Layout(batch_spec(mesh, micros.ndim - 1, micros.shape[1]),
                     micros.shape[1:], mesh)
        rows = np.concatenate([m[lay.index()] for m in micros])
        out[k] = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
    return out


def design_matrix(n: int, p: int, *, corr: float = 0.0, rng=None,
                  seed: int = 0) -> np.ndarray:
    """I.i.d. standard Gaussian columns, optionally AR(1)-correlated
    (pairwise corr^{|i−j|}). Pass ``rng`` to keep drawing from an existing
    generator, or ``seed`` for a standalone dictionary."""
    if rng is None:
        rng = np.random.default_rng(seed)
    if corr > 0:
        base = rng.standard_normal((n, p))
        X = np.empty((n, p))
        X[:, 0] = base[:, 0]
        a = np.sqrt(1.0 - corr * corr)
        for j in range(1, p):
            X[:, j] = corr * X[:, j - 1] + a * base[:, j]
        return X
    return rng.standard_normal((n, p))


def lasso_problem(n: int, p: int, *, nnz: int, corr: float = 0.0,
                  sigma: float = 0.1, seed: int = 0, dtype=np.float64):
    """Synthetic 1 (corr=0) or Synthetic 2 (corr=0.5): X, a ``nnz``-sparse
    β* with uniform(−1, 1) entries, y = Xβ* + σ·ε. Returns (X, y, β*)."""
    rng = np.random.default_rng(seed)
    X = design_matrix(n, p, corr=corr, rng=rng)
    beta = np.zeros(p)
    idx = rng.choice(p, nnz, replace=False)
    beta[idx] = rng.uniform(-1.0, 1.0, nnz)
    y = X @ beta + sigma * rng.standard_normal(n)
    return X.astype(dtype), y.astype(dtype), beta


@functools.lru_cache(maxsize=8)
def _cached_design(n: int, p: int, corr: float, seed: int) -> np.ndarray:
    """The dictionary of a :class:`QueryStream`, made once per (n, p,
    corr, seed) and marked read-only (consumers get copies)."""
    X = design_matrix(n, p, corr=corr, seed=seed)
    X.setflags(write=False)
    return X


@dataclasses.dataclass(frozen=True)
class QueryStream:
    """Lasso queries against ONE fixed dictionary: X is a pure function of
    ``(n, p, corr, seed)``; each query is the §4.1.2 recipe (a ``nnz``-
    sparse uniform(−1, 1) β*, y = Xβ* + σ·ε) drawn from
    ``SeedSequence([seed, step, shard, q])``, so any slice of the stream
    replays in isolation."""

    n: int
    p: int
    batch: int                    # queries per (step, shard) batch
    nnz: int = 10
    corr: float = 0.0
    sigma: float = 0.1
    seed: int = 0

    def dictionary(self, dtype=np.float64) -> np.ndarray:
        """The fixed design matrix X (n, p), a fresh copy."""
        return _cached_design(self.n, self.p, self.corr,
                              self.seed).astype(dtype)

    def host_batch(self, step: int, shard: int = 0, n_shards: int = 1,
                   dtype=np.float64) -> dict:
        """``{"y": (b, n), "beta": (b, p)}`` for (step, shard), with
        b = batch // n_shards."""
        b = self.batch // n_shards
        X = _cached_design(self.n, self.p, self.corr, self.seed)
        ys = np.empty((b, self.n))
        betas = np.zeros((b, self.p))
        for q in range(b):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, shard, q]))
            idx = rng.choice(self.p, self.nnz, replace=False)
            betas[q, idx] = rng.uniform(-1.0, 1.0, self.nnz)
            ys[q] = X @ betas[q] + self.sigma * rng.standard_normal(self.n)
        return {"y": ys.astype(dtype), "beta": betas.astype(dtype)}

    def queries(self, count: int, shard: int = 0, n_shards: int = 1,
                dtype=np.float64):
        """The first ``count`` queries in (step, query) order, the same
        draws as :meth:`host_batch`."""
        served, step = 0, 0
        while served < count:
            for y in self.host_batch(step, shard, n_shards, dtype)["y"]:
                if served >= count:
                    return
                yield y
                served += 1
            step += 1


def group_lasso_problem(n: int, p: int, m: int, *, active_groups: int,
                        sigma: float = 0.1, seed: int = 0, dtype=np.float64):
    """§4.2: i.i.d. Gaussian X, a group-sparse β* (``active_groups`` of the
    p/m equal groups of m with uniform(−1, 1) entries), y = Xβ* + σ·ε.
    Returns (X, y, β*)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    g = p // m
    beta = np.zeros(p)
    for gi in rng.choice(g, active_groups, replace=False):
        beta[gi * m:(gi + 1) * m] = rng.uniform(-1.0, 1.0, m)
    y = X @ beta + sigma * rng.standard_normal(n)
    return X.astype(dtype), y.astype(dtype), beta
