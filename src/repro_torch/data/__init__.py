"""Synthetic Lasso and group-Lasso problems, the query stream and the LM
token stream (numpy), ``to_device`` and ``device_batch``."""
from .pipeline import (  # noqa: F401
    QueryStream,
    SyntheticLM,
    design_matrix,
    device_batch,
    group_lasso_problem,
    lasso_problem,
    to_device,
)
