"""The synthetic training stream (port of ``repro.data``)."""
from . import pipeline  # noqa: F401
from .pipeline import DataConfig, SyntheticLM, make_batch_np  # noqa: F401
