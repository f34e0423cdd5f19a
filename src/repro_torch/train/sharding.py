"""Re-export of :mod:`repro_torch.pshard` (kept for the train-layer
import path, as the reference's ``repro.train.sharding``)."""

from ..pshard import (  # noqa: F401
    DEFAULT_RULES,
    batch_axes,
    batch_spec,
    constrain,
    physical_axes,
    resolve_spec,
    resolve_tree,
    set_activation_mesh,
)
