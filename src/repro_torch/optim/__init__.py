"""The LM stack's optimizer: the reference's AdamW arithmetic."""
from . import adamw  # noqa: F401
from .adamw import AdamState, OptConfig  # noqa: F401
