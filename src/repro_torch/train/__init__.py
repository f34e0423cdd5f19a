"""The LM stack's train, prefill and decode steps (one device)."""
from . import steps  # noqa: F401
from .steps import (  # noqa: F401
    TrainConfig,
    TrainState,
    init_state,
    make_train_step,
)
