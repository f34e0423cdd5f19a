"""Synthetic Lasso and group-Lasso problems and the query stream (numpy
only)."""
from .pipeline import (  # noqa: F401
    QueryStream,
    design_matrix,
    group_lasso_problem,
    lasso_problem,
)
