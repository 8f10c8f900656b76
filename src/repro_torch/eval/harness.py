"""Engine-based multiple-choice likelihood scoring.

Port of ``repro.eval.harness``.  Every choice of every item scores through
:meth:`repro_torch.serve.engine.Engine.score_continuations`: the engine's
packed weights, quant method and per-layer policy apply as they do in
serving, and scores are batch-invariant, so accuracies do not depend on
how items are batched.

Gold labels come from the FLOAT reference model
(:func:`gold_labels_and_margins`): accuracy is the fraction of items where
the candidate engine ranks the choices the way the unquantized model
does.  The float margins also grade item difficulty: :func:`hard_subset`
keeps the items with the smallest margins, :func:`decided_subset` drops
the coin flips.

Where the JAX functions take ``(params, cfg)``, these take ``(model,
cfg)``: the port's raw :class:`~repro_torch.models.model.Model` and the
config to score it under.  The float engine runs over a
:func:`~repro_torch.models.model.shared` view of the model, so the model
itself is neither packed nor copied.
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.model import shared
from repro_torch.serve.engine import Engine, ServeConfig

from .tasks import MCTask

__all__ = ["score_task", "gold_labels_and_margins", "hard_subset",
           "decided_subset", "decided_tasks", "evaluate", "float_engine",
           "STANDARD_MARGIN_FLOORS"]


def float_engine(model, cfg, max_len: int = 512) -> Engine:
    """The unquantized reference engine (gold-label oracle), on the
    model's device."""
    return Engine(shared(model, cfg.replace(quant=None, quant_method=None)),
                  ServeConfig(max_len=max_len, pack=False), device=model.device)


def score_task(engine: Engine, task: MCTask, batch_items: int = 16) -> np.ndarray:
    """(n_items, n_choices) continuation log-prob sums."""
    seqs, plens = [], []
    for item in task.items:
        for s, p in item.sequences():
            seqs.append(s)
            plens.append(p)
    nc = task.n_choices
    out = np.empty(len(seqs), np.float32)
    step = max(batch_items, 1) * nc  # keep an item's choices in one batch
    for i in range(0, len(seqs), step):
        out[i:i + step] = engine.score_continuations(
            seqs[i:i + step], plens[i:i + step])
    return out.reshape(len(task.items), nc)


def gold_labels_and_margins(model, cfg, task: MCTask, batch_items: int = 16):
    """(labels, margins) under the float reference model: ``labels[i]``
    is the reference's argmax choice, ``margins[i]`` the log-prob gap
    between its best and second-best choice."""
    scores = score_task(float_engine(model, cfg), task, batch_items)
    order = np.sort(scores, axis=1)
    return scores.argmax(axis=1), order[:, -1] - order[:, -2]


def hard_subset(task: MCTask, margins: np.ndarray, frac: float = 0.5) -> MCTask:
    """The ``frac`` of items with the smallest float margins (ties broken
    by item index — deterministic)."""
    n_keep = max(int(round(len(task.items) * frac)), 1)
    idx = np.argsort(margins, kind="stable")[:n_keep]
    return task.subset(sorted(int(i) for i in idx))


def decided_subset(task: MCTask, gold: np.ndarray, margins: np.ndarray,
                   min_margin: float):
    """(task', gold') restricted to the items the reference model decides:
    float margin >= ``min_margin``.  Items the float model scores within
    the quantization noise floor are coin flips that only add noise to the
    accuracy axis."""
    keep = [i for i in range(len(task.items)) if margins[i] >= min_margin]
    if not keep:
        raise ValueError(f"no items with margin >= {min_margin}")
    return task.subset(keep), np.asarray(gold)[keep]


def evaluate(engine: Engine, task: MCTask, gold: np.ndarray,
             batch_items: int = 16) -> float:
    """Fraction of items where the engine agrees with the gold choice."""
    scores = score_task(engine, task, batch_items)
    return float(np.mean(scores.argmax(axis=1) == np.asarray(gold)))


# per-task decided-item margin floors for the standard suite: boolq scores
# one token, winogrande sums ~5 — its noise scale is ~sqrt(len) larger
STANDARD_MARGIN_FLOORS = (1.0, 2.0)


def decided_tasks(model, cfg, n_items: int,
                  margin_floors=STANDARD_MARGIN_FLOORS,
                  batch_items: int = 16):
    """The standard two-task decided-item suite: (tasks, golds).
    ``n_items`` of boolq / winogrande over the model's vocab, gold labels
    and margins from the float reference, the decided items kept."""
    from .tasks import boolq_synthetic, winogrande_synthetic

    tasks, golds = [], []
    for t, lo in zip((boolq_synthetic(cfg.vocab_size, n_items),
                      winogrande_synthetic(cfg.vocab_size, n_items)),
                     margin_floors):
        g, m = gold_labels_and_margins(model, cfg, t, batch_items)
        tt, gg = decided_subset(t, g, m, lo)
        tasks.append(tt)
        golds.append(gg)
    return tasks, golds
