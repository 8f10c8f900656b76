"""Deterministic fault injection and invariants for the serving engine.

Port of ``repro.serve.faults``: :class:`NumericFault` (:52),
``_FaultyAllocator`` (:66) over the port's
:class:`~repro_torch.serve.blocks.BlockAllocator`, :class:`FaultPlan`
(:92, with ``seeded`` :130) and :func:`check_invariants` (:283).  The
plan is host bookkeeping and ports nearly verbatim: ``seeded`` draws from
the same numpy generator, so one seed gives the JAX plan field for field.
What differs is where a NaN lands: :meth:`FaultPlan.corrupt_logits` and
:meth:`FaultPlan.corrupt_finite` take and return torch tensors on the
engine's device (a copy with the chosen lanes poisoned), where the JAX
plan returns numpy arrays.

Production FP8 serving has three failure families the scheduler must
degrade through instead of dying: memory pressure (block-pool exhaustion,
COW contention under prefix sharing), numeric faults (NaN/Inf escaping the
low-precision path) and control events (cancellation, deadline expiry).
The same plan against the same request mix replays the same failures, and
every fault is injected at the real failure site: allocator calls raise
the real :class:`~repro_torch.serve.blocks.BlockError`, NaNs land in the
logits the guard inspects, cancels go through the engine's own drain.

Injection-point indexing (all 0-based):

* ``alloc_failures`` / ``cow_failures`` count ``alloc()`` and
  ``ensure_writable()`` calls on the plan's allocator over one serve call.
* ``nan_steps`` counts guard-inspected decode-phase calls (one per decode
  step or speculation round); admission prefills are not targets.
* ``cancels`` counts scheduler iterations.
* ``spec_mismatch_rounds`` counts speculation rounds; a hit clamps the
  accepted length to 1.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.serve import blocks as SB

__all__ = ["FaultPlan", "NumericFault", "check_invariants"]


class NumericFault(RuntimeError):
    """A non-finite logit reached sampling under the ``fail-fast`` numeric
    guard; carries the offending request uids and the decode-phase call
    index."""

    def __init__(self, uids, step: int):
        self.uids = list(uids)
        self.step = int(step)
        super().__init__(
            f"non-finite logits at decode call {step} for request(s) "
            f"{self.uids!r} (numeric_guard='fail-fast'; use 'quarantine' or "
            f"'fallback' to degrade per-lane instead)")


class _FaultyAllocator(SB.BlockAllocator):
    """A BlockAllocator that consults its :class:`FaultPlan` before every
    ``alloc`` / ``ensure_writable``: an injected failure raises the same
    :class:`BlockError` as real exhaustion, before any state mutates."""

    def __init__(self, plan: "FaultPlan", num_blocks: int, block_size: int):
        super().__init__(num_blocks, block_size)
        self._plan = plan

    def alloc(self, n: int = 1):
        if self._plan._take_alloc_fault():
            raise SB.BlockError(
                f"[fault-injected] allocator refused {n} block(s) "
                f"(plan seed {self._plan.seed})")
        return super().alloc(n)

    def ensure_writable(self, table, logical_blocks):
        if self._plan._take_cow_fault():
            raise SB.BlockError(
                f"[fault-injected] COW split refused "
                f"(plan seed {self._plan.seed})")
        return super().ensure_writable(table, logical_blocks)


def _hit_lanes(lanes, occupied) -> list:
    """The plan's lanes for one call (an int, a tuple, or "all"), cut to
    the lanes actually serving."""
    if lanes == "all":
        lanes = list(occupied)
    elif np.isscalar(lanes):
        lanes = [int(lanes)]
    occ = set(occupied)
    return [l for l in lanes if l in occ]


@dataclasses.dataclass
class FaultPlan:
    """A deterministic schedule of injected serving faults.  Pass it to
    ``Engine.serve(..., faults=plan)``; the engine calls :meth:`reset` on
    entry, so one plan object replays identically across serve calls."""

    seed: int = 0
    # allocator call indices (0-based) whose alloc() raises BlockError
    alloc_failures: frozenset = frozenset()
    # ensure_writable() call indices that raise BlockError (COW contention)
    cow_failures: frozenset = frozenset()
    # decode-phase call index -> lane ids whose logits become NaN (an int
    # lane, a tuple of lanes, or "all")
    nan_steps: dict = dataclasses.field(default_factory=dict)
    # True: a nan_steps hit also corrupts the 'fallback' policy's
    # reference-path retry (a fault upstream of the kernel choice)
    persistent_nan: bool = False
    # scheduler iteration -> request uids to cancel at that iteration
    cancels: dict = dataclasses.field(default_factory=dict)
    # speculation round indices whose accepted length clamps to 1
    spec_mismatch_rounds: frozenset = frozenset()

    def __post_init__(self):
        self.alloc_failures = frozenset(int(i) for i in self.alloc_failures)
        self.cow_failures = frozenset(int(i) for i in self.cow_failures)
        self.spec_mismatch_rounds = frozenset(int(i) for i in self.spec_mismatch_rounds)
        self.reset()

    @classmethod
    def seeded(cls, seed: int, *, uids=(), n_alloc: int = 2, n_cow: int = 2,
               n_nan: int = 1, n_cancel: int = 1, n_spec: int = 0,
               decode_calls: int = 32, alloc_calls: int = 32,
               steps: int = 32, lanes: int = 4) -> "FaultPlan":
        """The standard randomized plan: ``n_alloc`` allocator and ``n_cow``
        COW refusals in the first ``alloc_calls`` allocator calls, ``n_nan``
        NaN injections over ``decode_calls`` x ``lanes``, ``n_cancel``
        cancels of ``uids`` members over ``steps`` iterations and
        ``n_spec`` spec-mismatch rounds.  Same seed -> the JAX package's
        plan, field for field (the same numpy draws in the same order)."""
        rng = np.random.default_rng(seed)

        def pick(n, hi):
            n = min(int(n), int(hi))
            return frozenset(int(i) for i in rng.choice(hi, size=n, replace=False)) \
                if n > 0 else frozenset()

        nan_steps = {}
        for i in sorted(pick(n_nan, decode_calls)):
            nan_steps[i] = (int(rng.integers(lanes)),)
        cancels = {}
        uids = list(uids)
        if uids and n_cancel > 0:
            victims = rng.choice(len(uids), size=min(n_cancel, len(uids)), replace=False)
            for v in victims:
                # late enough that the request usually got admitted
                cancels.setdefault(int(rng.integers(1, max(steps, 2))), []).append(uids[v])
        return cls(seed=seed,
                   alloc_failures=pick(n_alloc, alloc_calls),
                   cow_failures=pick(n_cow, alloc_calls),
                   nan_steps=nan_steps,
                   cancels={k: tuple(v) for k, v in cancels.items()},
                   spec_mismatch_rounds=pick(n_spec, decode_calls))

    # -- engine hooks (deterministic, counter-driven) --------------------

    def reset(self) -> None:
        """Rewind every injection counter (the engine calls this at the top
        of each serve())."""
        self._n_alloc = 0
        self._n_cow = 0
        self._n_decode = 0
        self._n_spec = 0
        self.injected = {"alloc": 0, "cow": 0, "nan": 0, "cancel": 0, "spec": 0}
        # called as observer(kind, index) at every injection (the engine
        # wires ServeRecorder.fault_injected here after reset)
        self.observer = None

    def _notify(self, kind: str, index: int) -> None:
        if self.observer is not None:
            self.observer(kind, int(index))

    def allocator(self, num_blocks: int, block_size: int) -> SB.BlockAllocator:
        """A real BlockAllocator whose alloc/ensure_writable consult this
        plan first (the engine's pool allocator while a plan is active)."""
        return _FaultyAllocator(self, num_blocks, block_size)

    def _take_alloc_fault(self) -> bool:
        i, self._n_alloc = self._n_alloc, self._n_alloc + 1
        hit = i in self.alloc_failures
        self.injected["alloc"] += hit
        if hit:
            self._notify("alloc", i)
        return hit

    def _take_cow_fault(self) -> bool:
        i, self._n_cow = self._n_cow, self._n_cow + 1
        hit = i in self.cow_failures
        self.injected["cow"] += hit
        if hit:
            self._notify("cow", i)
        return hit

    def corrupt_logits(self, last: torch.Tensor, occupied, *, retry: bool = False):
        """NaNs into this decode call's last-token logits ``last`` (B, V)
        for the plan's lanes among ``occupied``: a float32 copy on the same
        device, or ``last`` itself when nothing fires.  ``retry=True`` marks
        the 'fallback' policy's re-run, corrupted again only under
        ``persistent_nan``."""
        if not retry:
            i, self._n_decode = self._n_decode, self._n_decode + 1
        else:
            if not self.persistent_nan:
                return last
            i = self._n_decode - 1
        lanes = self.nan_steps.get(i)
        if lanes is None:
            return last
        lanes = _hit_lanes(lanes, occupied)
        if not lanes:
            return last
        out = last.to(torch.float32, copy=True)
        out[torch.as_tensor(lanes, device=out.device)] = float("nan")
        self.injected["nan"] += 1
        self._notify("nan", i)
        return out

    def corrupt_finite(self, finite: torch.Tensor, occupied):
        """The speculation round's twin of :meth:`corrupt_logits`: a NaN
        injection forces the round's per-lane finiteness verdict ``finite``
        (B,) bool to False for the chosen lanes (a copy)."""
        i, self._n_decode = self._n_decode, self._n_decode + 1
        lanes = self.nan_steps.get(i)
        if lanes is None:
            return finite
        lanes = _hit_lanes(lanes, occupied)
        if not lanes:
            return finite
        out = finite.clone()
        out[torch.as_tensor(lanes, device=out.device)] = False
        self.injected["nan"] += 1
        self._notify("nan", i)
        return out

    def cancels_at(self, step: int):
        """Request uids the plan cancels at scheduler iteration ``step``."""
        uids = self.cancels.get(int(step), ())
        self.injected["cancel"] += len(tuple(uids))
        if uids:
            self._notify("cancel", step)
        return tuple(uids) if not isinstance(uids, (str, bytes)) else (uids,)

    def clip_spec_keep(self, keep):
        """Clamp this round's accepted lengths (host array) to 1 when the
        plan schedules a verify mismatch here (0 lanes stay 0: idle)."""
        i, self._n_spec = self._n_spec, self._n_spec + 1
        if i not in self.spec_mismatch_rounds:
            return keep
        self.injected["spec"] += 1
        self._notify("spec", i)
        return np.minimum(np.asarray(keep), 1) * (np.asarray(keep) > 0)


def check_invariants(alloc, tables=None, lanes=None, prefix=None, out=None,
                     uids=None) -> None:
    """Assert block bookkeeping conservation (AssertionError with the diff
    otherwise): every refcount equals its live holders (table entries of
    live lanes plus the prefix cache's reference), the free list and the
    held set partition the pool, a released lane's table row is all zero,
    and (with ``out``/``uids``) every request uid has an output entry."""
    n = alloc.num_blocks
    ref = alloc.refcounts()
    expect = np.zeros(n, np.int64)
    expect[SB.SCRATCH_BLOCK] = 1
    if tables is not None:
        live = ([l is not None for l in lanes] if lanes is not None
                else [True] * len(tables))
        for i, row in enumerate(np.asarray(tables)):
            if not live[i]:
                assert not row.any(), (
                    f"released lane {i} still holds block ids {row[row != 0].tolist()}")
                continue
            for b in row:
                if b:
                    expect[int(b)] += 1
    if prefix is not None:
        for b in prefix.block_ids():
            expect[int(b)] += 1
    mism = np.nonzero(ref != expect)[0]
    assert mism.size == 0, (
        f"refcount conservation violated at blocks {mism.tolist()}: refcounts "
        f"{ref[mism].tolist()} vs live holders {expect[mism].tolist()}")
    free = list(alloc.free_list())
    assert len(free) == len(set(free)), f"free list has duplicates: {free}"
    held = {b for b in range(1, n) if ref[b] > 0}
    dup = set(free) & held
    assert not dup, f"blocks both free and referenced: {sorted(dup)}"
    assert set(free) | held == set(range(1, n)), (
        f"lost blocks: {sorted(set(range(1, n)) - set(free) - held)}")
    if out is not None and uids is not None:
        missing = [u for u in uids if u not in out]
        assert not missing, f"requests lost without a result: {missing!r}"
