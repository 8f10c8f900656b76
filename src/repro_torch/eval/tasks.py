"""Deterministic synthetic multiple-choice likelihood tasks.

Port of ``repro.eval.tasks`` (numpy, copied as it is: the same seed gives
the same items in both packages).

Two generators mirror the paper's eval suite shapes (BoolQ and Winogrande,
Table: DSBP vs fixed-bitwidth at equal accuracy):

* :func:`boolq_synthetic` — a longer "passage + question" context followed
  by one of two fixed single-token answers (the yes/no shape): scoring
  reads one next-token distribution per item.
* :func:`winogrande_synthetic` — a short context with two multi-token
  candidate "referents" that share a common suffix (the
  fill-in-the-blank-then-continue shape): scoring sums continuation
  log-probs over several tokens.

Items are pure functions of (vocab_size, n_items, seed) via a dedicated
``np.random.default_rng`` — fully deterministic, no external data.  Gold
labels are NOT generated here: the harness derives them from the float
reference model, so accuracy measures behavior preservation under
quantization (repro_torch/eval/harness.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["MCItem", "MCTask", "boolq_synthetic", "winogrande_synthetic"]


@dataclasses.dataclass(frozen=True)
class MCItem:
    """One multiple-choice item: context + candidate continuations."""

    context: tuple[int, ...]
    choices: tuple[tuple[int, ...], ...]

    def sequences(self):
        """(full token sequence, context length) per choice."""
        return [(np.asarray(self.context + c, np.int64), len(self.context))
                for c in self.choices]


@dataclasses.dataclass
class MCTask:
    name: str
    items: list[MCItem]
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def n_choices(self) -> int:
        return len(self.items[0].choices)

    def subset(self, idx) -> "MCTask":
        return MCTask(name=self.name, items=[self.items[i] for i in idx],
                      meta=dict(self.meta, subset_of=len(self.items)))


def boolq_synthetic(vocab_size: int, n_items: int = 64, seed: int = 11,
                    ctx_len: int = 24) -> MCTask:
    """Passage+question contexts with two fixed single-token answers."""
    rng = np.random.default_rng(seed)
    # two distinct fixed "yes"/"no" answer ids, away from token 0 (the pad)
    yes, no = (int(a) for a in
               rng.choice(np.arange(1, vocab_size), size=2, replace=False))
    sep = int(rng.integers(1, vocab_size))  # the "question marker" token
    items = []
    for _ in range(n_items):
        L = int(rng.integers(max(ctx_len // 2, 2), ctx_len + 1))
        passage = rng.integers(1, vocab_size, L).tolist()
        items.append(MCItem(context=tuple(passage) + (sep,),
                            choices=((yes,), (no,))))
    return MCTask("boolq_syn", items,
                  meta={"seed": seed, "vocab_size": vocab_size,
                        "answers": (yes, no), "ctx_len": ctx_len})


def winogrande_synthetic(vocab_size: int, n_items: int = 64, seed: int = 13,
                         ctx_len: int = 10, opt_len: int = 2,
                         suffix_len: int = 3) -> MCTask:
    """Short contexts; two multi-token options sharing a common suffix."""
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n_items):
        ctx = tuple(rng.integers(1, vocab_size, ctx_len).tolist())
        suffix = tuple(rng.integers(1, vocab_size, suffix_len).tolist())
        o1 = tuple(rng.integers(1, vocab_size, opt_len).tolist())
        o2 = tuple(rng.integers(1, vocab_size, opt_len).tolist())
        while o2 == o1:  # options must differ
            o2 = tuple(rng.integers(1, vocab_size, opt_len).tolist())
        items.append(MCItem(context=ctx, choices=(o1 + suffix, o2 + suffix)))
    return MCTask("winogrande_syn", items,
                  meta={"seed": seed, "vocab_size": vocab_size,
                        "ctx_len": ctx_len, "opt_len": opt_len,
                        "suffix_len": suffix_len})
