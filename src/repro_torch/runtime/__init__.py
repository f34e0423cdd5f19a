"""Elastic, checkpointed run driver."""
from .elastic import (  # noqa: F401
    ElasticConfig,
    RunReport,
    SimulatedFailure,
    run_elastic,
)
