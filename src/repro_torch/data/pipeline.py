"""The paper's synthetic problems, numpy only: the §4.1.2 Lasso problems
(eq. 74) and the §4.2 group-Lasso problems.

A copy of ``design_matrix``, ``lasso_problem`` and ``group_lasso_problem``
from the reference's ``data/pipeline.py``: the same seed gives the same
arrays, so both packages can be fed identical problems.
"""

from __future__ import annotations

import numpy as np


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
