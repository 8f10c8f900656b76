"""Deterministic synthetic LM data pipeline — sharded, resumable.

Port of ``repro.data.pipeline``: plain numpy, so the same (seed, step,
shard) gives the same batch in both packages, frontend branches included.

Real corpora are unavailable offline, so the pipeline synthesizes token
streams from a seeded Markov-ish generator with enough structure for a small
model's loss to drop well below ln(V) (``tests/test_torch_train.py``).  The pipeline
contract is production-shaped:

  * host-sharded: each data-parallel host draws only its shard (seeded by
    (seed, step, shard)), no cross-host coordination needed;
  * resumable: batch at step t is a pure function of (seed, t) — restart at
    any checkpoint step reproduces the same stream;
  * modality-aware: emits codebook tokens for audio archs and patch
    embeddings for VLM archs (frontend stubs, as the models are).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs import ArchConfig

__all__ = ["DataConfig", "SyntheticLM", "make_batch_np"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch_size: int = 8  # per-host batch
    seq_len: int = 128
    n_shards: int = 1
    shard: int = 0


class SyntheticLM:
    """Structured synthetic stream: a random sparse bigram machine.

    Transition sparsity gives the data ~2.5 bits/token of structure, so
    cross-entropy has real headroom below ln(V).
    """

    def __init__(self, cfg: DataConfig, arch: ArchConfig):
        self.cfg = cfg
        self.arch = arch
        base = np.random.default_rng(cfg.seed)
        v = arch.vocab_size
        self.fanout = max(2, min(16, v // 8))
        self.table = base.integers(0, v, (v, self.fanout), dtype=np.int64)

    def _tokens(self, rng, b, s):
        v = self.arch.vocab_size
        out = np.empty((b, s + 1), np.int64)
        out[:, 0] = rng.integers(0, v, b)
        choices = rng.integers(0, self.fanout, (b, s))
        mistakes = rng.random((b, s)) < 0.05  # 5% noise
        noise = rng.integers(0, v, (b, s))
        for t in range(s):
            nxt = self.table[out[:, t], choices[:, t]]
            out[:, t + 1] = np.where(mistakes[:, t], noise[:, t], nxt)
        return out

    def batch(self, step: int) -> dict:
        """Batch for global ``step`` on this shard (pure function of args)."""
        c = self.cfg
        rng = np.random.default_rng(
            (c.seed * 1_000_003 + step) * 65_537 + c.shard
        )
        b, s = c.batch_size, c.seq_len
        a = self.arch
        if a.frontend == "audio_codebooks":
            toks = np.stack(
                [self._tokens(rng, b, s) for _ in range(a.n_codebooks)], axis=-1
            )
            return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        batch = {}
        toks = self._tokens(rng, b, s)
        batch["tokens"] = toks[:, :-1]
        batch["labels"] = toks[:, 1:]
        if a.frontend == "vlm_patches":
            batch["image_embeds"] = rng.standard_normal(
                (b, a.n_image_tokens, a.d_model)
            ).astype(np.float32)
        return batch

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_batch_np(arch: ArchConfig, batch: int, seq: int, seed: int = 0) -> dict:
    """One-shot batch helper for tests/benchmarks."""
    return SyntheticLM(DataConfig(seed=seed, batch_size=batch, seq_len=seq), arch).batch(0)
