"""Synthetic Lasso and group-Lasso problems (numpy only)."""
from .pipeline import (  # noqa: F401
    design_matrix,
    group_lasso_problem,
    lasso_problem,
)
