"""AdamW over a model's named parameters (port of ``repro.optim``)."""
from . import adamw  # noqa: F401
