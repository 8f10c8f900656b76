"""Synthetic multiple-choice likelihood eval (port of ``repro.eval``).

Deterministic BoolQ/Winogrande-style task generators (``tasks.py``) scored
batch-invariantly through :class:`repro_torch.serve.engine.Engine`
(``harness.py``).  Gold labels come from the float reference model, so
accuracy measures behaviour preservation under quantization.
"""
from .harness import (decided_subset, decided_tasks, evaluate, gold_labels_and_margins,
                      hard_subset, score_task)
from .tasks import MCItem, MCTask, boolq_synthetic, winogrande_synthetic

__all__ = [
    "MCItem",
    "MCTask",
    "boolq_synthetic",
    "winogrande_synthetic",
    "score_task",
    "gold_labels_and_margins",
    "hard_subset",
    "decided_subset",
    "decided_tasks",
    "evaluate",
]
