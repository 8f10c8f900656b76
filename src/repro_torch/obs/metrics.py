"""Host-side metrics registry: counters, gauges, fixed-bucket histograms.

Port of ``repro.obs.metrics`` (pure Python, verbatim in behaviour: the
same snapshot and the same Prometheus text for the same operations).

Design constraints:

- **Host-side and allocation-light.**  Every instrument is a tiny Python
  object mutated from the scheduler loop; nothing touches the device or
  forces a sync.  Series handles are cached by the caller (the recorder
  resolves each ``(name, labels)`` pair once), so the per-step cost is an
  attribute add.
- **Fixed buckets.**  Histograms take an ascending upper-bound tuple at
  creation and never rebucket — exports are comparable across runs and
  the observe path is one bisect.  Bucket semantics follow Prometheus:
  bucket ``i`` counts observations with ``value <= bound[i]`` exclusive of
  lower bounds, plus an implicit ``+Inf`` overflow bucket.
- **Two exports, one source of truth.**  :meth:`MetricsRegistry.snapshot`
  emits a JSON-able dict that round-trips via :meth:`from_snapshot`;
  :meth:`to_prometheus` renders the standard text exposition format.
"""
from __future__ import annotations

from bisect import bisect_left

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS",
]

# seconds; spans 0.5 ms kernels to multi-second smoke prefills
DEFAULT_LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                           0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


class Counter:
    """Monotonically non-decreasing count."""

    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Fixed-bucket histogram with Prometheus ``le`` (value <= bound)
    semantics and an implicit ``+Inf`` overflow bucket."""

    kind = "histogram"
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets=DEFAULT_LATENCY_BUCKETS):
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"buckets must be strictly ascending: {b}")
        self.buckets = b
        self.counts = [0] * (len(b) + 1)  # [..per-bound.., +Inf]
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        # first bound with v <= bound; len(buckets) is the +Inf bucket
        self.counts[bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def cumulative(self):
        """Running ``(le_bound, cumulative_count)`` pairs; the last bound
        is ``"+Inf"`` and its count equals :attr:`count`."""
        out, running = [], 0
        for bound, c in zip(self.buckets, self.counts):
            running += c
            out.append((bound, running))
        out.append(("+Inf", running + self.counts[-1]))
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def _fmt(v: float) -> str:
    return f"{int(v)}" if float(v).is_integer() else f"{v:.10g}"


class MetricsRegistry:
    """Name → labelled-series families of counters/gauges/histograms."""

    def __init__(self):
        # name -> {"kind", "help", "series": {labels_tuple: instrument}}
        self._families: dict = {}

    # -- instrument accessors (create-on-first-use, cached thereafter) --

    def _series(self, kind, name, help_, labels, factory):
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = {"kind": kind, "help": help_,
                                          "series": {}}
        elif fam["kind"] != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{fam['kind']}, not {kind}")
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        inst = fam["series"].get(key)
        if inst is None:
            inst = fam["series"][key] = factory()
        return inst

    def counter(self, name, help="", **labels) -> Counter:
        return self._series("counter", name, help, labels, Counter)

    def gauge(self, name, help="", **labels) -> Gauge:
        return self._series("gauge", name, help, labels, Gauge)

    def histogram(self, name, buckets=DEFAULT_LATENCY_BUCKETS, help="",
                  **labels) -> Histogram:
        return self._series("histogram", name, help, labels,
                            lambda: Histogram(buckets))

    def value(self, name, **labels):
        """Convenience read: the instrument's value (histograms: ``sum``)."""
        fam = self._families.get(name)
        if fam is None:
            return None
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        inst = fam["series"].get(key)
        if inst is None:
            return None
        return inst.sum if isinstance(inst, Histogram) else inst.value

    # ------------------------------ exports ------------------------------

    def snapshot(self) -> dict:
        fams = {}
        for name in sorted(self._families):
            fam = self._families[name]
            series = []
            for key in sorted(fam["series"]):
                inst = fam["series"][key]
                row: dict = {"labels": dict(key)}
                if isinstance(inst, Histogram):
                    row.update(buckets=list(inst.buckets),
                               counts=list(inst.counts),
                               sum=inst.sum, count=inst.count)
                else:
                    row["value"] = inst.value
                series.append(row)
            fams[name] = {"kind": fam["kind"], "help": fam["help"],
                          "series": series}
        return {"version": 1, "families": fams}

    @classmethod
    def from_snapshot(cls, snap: dict) -> "MetricsRegistry":
        reg = cls()
        for name, fam in snap["families"].items():
            for row in fam["series"]:
                labels = row["labels"]
                if fam["kind"] == "histogram":
                    h = reg.histogram(name, buckets=row["buckets"],
                                      help=fam["help"], **labels)
                    h.counts = list(row["counts"])
                    h.sum, h.count = row["sum"], row["count"]
                else:
                    inst = reg._series(fam["kind"], name, fam["help"],
                                       labels, _KINDS[fam["kind"]])
                    inst.value = row["value"]
        return reg

    def to_prometheus(self) -> str:
        """Standard text exposition format (one family per # TYPE block)."""
        lines = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['kind']}")
            for key in sorted(fam["series"]):
                inst = fam["series"][key]
                base = ",".join(f'{k}="{v}"' for k, v in key)
                if isinstance(inst, Histogram):
                    for bound, cum in inst.cumulative():
                        le = bound if bound == "+Inf" else _fmt(bound)
                        lab = f'{base},le="{le}"' if base else f'le="{le}"'
                        lines.append(f"{name}_bucket{{{lab}}} {cum}")
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{name}_sum{suffix} {_fmt(inst.sum)}")
                    lines.append(f"{name}_count{suffix} {inst.count}")
                else:
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{name}{suffix} {_fmt(inst.value)}")
        return "\n".join(lines) + "\n"
