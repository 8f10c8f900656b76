"""Training: the QAT step, the restartable trainer and compressed
gradient reduction (port of ``repro.train``)."""
from . import grad_compress, trainer  # noqa: F401
