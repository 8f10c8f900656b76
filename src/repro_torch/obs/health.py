"""Quantization-health telemetry.

Port of ``repro.obs.health``: :func:`shift_drift`, :class:`EntryHealth`
and :class:`QuantHealth` (``attribute_trip``, ``sample_cache``,
``drift``).  Three signals, keyed by cache-entry name (``units.{i}`` /
``tail.{i}``, the granularity ``policy.kv_bits`` prices and
``policy.reprice_from_telemetry`` widens):

- **Guard-trip attribution.**  When the engine's numeric guard trips,
  :meth:`QuantHealth.attribute_trip` scans the live KV cache per entry for
  non-finite values: a real numeric fault in a layer poisons that entry's
  cache writes.  A trip with a clean cache (a NaN a ``FaultPlan`` injected
  into the logits) counts as ``unattributed``.
- **Saturation drift**: the first sample freezes a per-entry tensor scale;
  later samples count values that over/underflow the probe format under
  that frozen scale (:func:`repro_torch.kernels.ops.sat_counts`).
- **Shift-histogram drift**: per-entry alignment-shift histograms in the
  ``policy.kv_bits.collect_kv_stats`` form, compared with calibration by
  total-variation distance (:func:`shift_drift`).

The entry granularity is JAX's.  The port's cache is a list with one
``{'k', 'v'}`` per layer, where JAX stacks every layer of one pattern
position into one entry; ``Model.cache_tree`` groups the list into JAX's
``{"units": [...], "tail": [...]}`` tree, each entry the list of its
layers (all 32 layers of llama-7b-paper are the one entry ``units.0``).
So a trip is counted once per entry, and the frozen scale is the
per-tensor scale over the whole entry (its K, as JAX's first leaf), not
a per-layer one.  Everything is reduced on the cache's device: the counts
of an entry cross to the host once, never a tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.dsbp import MAX_SHIFT, group_shifts
from repro_torch.core.formats import decompose, get_format, scale_for_amax
from repro_torch.kvq import PackedKVBlock

__all__ = ["EntryHealth", "QuantHealth", "shift_drift"]


def shift_drift(hist, baseline) -> float:
    """Total-variation distance in [0, 1] between two normalized shift
    histograms; ``baseline`` may be a raw histogram or anything with a
    ``shift_hist`` attribute (e.g. ``policy.kv_bits.KVEntryStats``)."""
    h = np.asarray(hist, np.float64)
    b = np.asarray(getattr(baseline, "shift_hist", baseline), np.float64)
    n = max(h.size, b.size)
    h = np.pad(h, (0, n - h.size))
    b = np.pad(b, (0, n - b.size))
    h = h / max(h.sum(), 1.0)
    b = b / max(b.sum(), 1.0)
    return 0.5 * float(np.abs(h - b).sum())


@dataclasses.dataclass
class EntryHealth:
    """Accumulated health of one cache entry."""

    name: str
    guard_trips: int = 0
    nonfinite: int = 0
    overflow: int = 0
    underflow: int = 0
    total: int = 0          # elements inspected by sample_cache
    samples: int = 0
    tscale: float | None = None  # frozen at the first sample
    shift_hist: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(MAX_SHIFT + 1, np.int64))

    def snapshot(self) -> dict:
        return {"guard_trips": self.guard_trips,
                "nonfinite": self.nonfinite,
                "overflow": self.overflow,
                "underflow": self.underflow,
                "total": self.total,
                "samples": self.samples,
                "tscale": self.tscale,
                "shift_hist": self.shift_hist.tolist()}


def _cache_entries(cache):
    """``(name, layers)`` for every ``units.{i}`` / ``tail.{i}`` entry of a
    cache tree (``Model.cache_tree``); an entry is one layer's ``{'k',
    'v'}`` or the list of the layers that share its name."""
    if not cache:
        return
    for fam in ("units", "tail"):
        for i, entry in enumerate(cache.get(fam, ())):
            yield f"{fam}.{i}", list(entry) if isinstance(entry, (list, tuple)) else [entry]


def _leaves(layer: dict):
    """Every tensor of one layer's cache: float leaves and both children
    of packed ones."""
    for leaf in layer.values():
        if isinstance(leaf, PackedKVBlock):
            yield leaf.qm
            yield leaf.scale
        else:
            yield leaf


def _values(leaf) -> torch.Tensor:
    """A K or V leaf as float rows of D: packed blocks dequantize."""
    x = leaf.dequantize() if isinstance(leaf, PackedKVBlock) else leaf.to(torch.float32)
    return x.reshape(-1, x.shape[-1])


class QuantHealth:
    """Per-entry quantization-health accumulator."""

    def __init__(self, probe: str = "e5m7"):
        self.probe = probe
        self.reset()

    def reset(self) -> None:
        self.entries: dict = {}
        self.unattributed_trips = 0
        self.samples = 0

    def entry(self, name: str) -> EntryHealth:
        e = self.entries.get(name)
        if e is None:
            e = self.entries[name] = EntryHealth(name)
        return e

    # --------------------------- guard trips ---------------------------

    def record_trip(self, name: str, n: int = 1) -> None:
        self.entry(name).guard_trips += n

    @property
    def total_trips(self) -> int:
        return (self.unattributed_trips
                + sum(e.guard_trips for e in self.entries.values()))

    def trips(self) -> dict:
        """Non-zero trip counts per entry (the reprice hook's input)."""
        return {n: e.guard_trips for n, e in self.entries.items() if e.guard_trips}

    def attribute_trip(self, cache, n: int = 1):
        """Blame a guard trip on the cache entries holding non-finite
        values (one trip per entry, however many of its layers hold them);
        returns the culprit names, empty when the fault never reached the
        cache (then the trip counts as unattributed)."""
        bad = []
        for name, layers in _cache_entries(cache):
            counts = [(~torch.isfinite(leaf)).sum() for layer in layers
                      for leaf in _leaves(layer) if leaf.is_floating_point()]
            nonfinite = int(torch.stack(counts).sum()) if counts else 0
            if nonfinite:
                e = self.entry(name)
                e.guard_trips += n
                e.nonfinite += nonfinite
                bad.append(name)
        if not bad:
            self.unattributed_trips += n
        return bad

    # ------------------------ saturation + shifts ------------------------

    def sample_cache(self, cache) -> None:
        """One health sample of the live cache: per-entry saturation counts
        under the frozen tensor scale plus alignment-shift histograms
        (``collect_kv_stats`` form).  Per entry, K's layers then V's, as
        JAX's stacked leaves; each entry's counts and histogram are summed
        on the device and read once."""
        from repro_torch.kernels.ops import sat_counts

        f = get_format(self.probe)
        for name, layers in _cache_entries(cache):
            groups = [[layer[key] for layer in layers if key in layer] for key in ("k", "v")]
            groups = [g for g in groups if g]
            if not groups:
                continue
            e = self.entry(name)
            dev = _values(groups[0][0]).device
            acc = torch.zeros(3 + MAX_SHIFT + 2, dtype=torch.int64, device=dev)
            for leaves in groups:
                if e.tscale is None:  # the scale over the whole stacked entry
                    amax = torch.stack([_values(x).abs().max() for x in leaves]).max()
                    e.tscale = float(scale_for_amax(amax, f))
                ts = torch.tensor(e.tscale, dtype=torch.float32, device=dev)
                for leaf in leaves:
                    x = _values(leaf)
                    acc[:3] += torch.stack(sat_counts(x, f, ts)[:3])
                    e.total += x.numel()
                    fields = decompose(torch.where(torch.isfinite(x), x,
                                                   torch.zeros_like(x)) * ts, f)
                    shift, _, nz = group_shifts(fields["e_unb"][..., None, :],
                                                fields["m_int"][..., None, :])
                    # zeros go to bin MAX_SHIFT + 1, cut below: a fixed length
                    codes = torch.where(nz, shift, MAX_SHIFT + 1).flatten()
                    acc[3:] += torch.bincount(codes, minlength=MAX_SHIFT + 2)
            counts = acc.tolist()
            e.overflow += counts[0]
            e.underflow += counts[1]
            e.nonfinite += counts[2]
            e.shift_hist += np.asarray(counts[3:3 + MAX_SHIFT + 1], np.int64)
            e.samples += 1
        self.samples += 1

    def drift(self, baseline: dict) -> dict:
        """Per-entry TV distance vs stored calibration stats (a dict of
        entry name -> ``KVEntryStats`` or raw histogram)."""
        return {name: shift_drift(e.shift_hist, baseline[name])
                for name, e in self.entries.items()
                if name in baseline and e.shift_hist.sum()}

    def snapshot(self) -> dict:
        return {"probe": self.probe,
                "samples": self.samples,
                "unattributed_trips": self.unattributed_trips,
                "total_trips": self.total_trips,
                "entries": {n: e.snapshot() for n, e in sorted(self.entries.items())}}
