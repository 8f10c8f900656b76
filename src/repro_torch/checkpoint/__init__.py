"""Atomic checkpoints in the JAX package's layout (port of ``repro.checkpoint``)."""
from . import store  # noqa: F401
from .store import latest_step, restore, save  # noqa: F401
