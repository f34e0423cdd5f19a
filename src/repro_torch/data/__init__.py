"""Synthetic Lasso problems (numpy only)."""
from .pipeline import design_matrix, lasso_problem  # noqa: F401
