"""Atomic step checkpoints in the reference's on-disk format."""
from .checkpoint import latest_step, restore, save  # noqa: F401
