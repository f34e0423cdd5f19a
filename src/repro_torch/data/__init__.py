"""Synthetic Lasso and group-Lasso problems, the query stream and the LM
token stream (numpy), and ``to_device``."""
from .pipeline import (  # noqa: F401
    QueryStream,
    SyntheticLM,
    design_matrix,
    group_lasso_problem,
    lasso_problem,
    to_device,
)
