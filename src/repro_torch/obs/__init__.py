"""Serving observability (port of ``repro.obs``): lifecycle tracing, a
metrics registry, and quantization-health telemetry behind one recorder."""
from .health import EntryHealth, QuantHealth, shift_drift
from .metrics import DEFAULT_LATENCY_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry
from .recorder import ServeRecorder
from .trace import TraceEvent, TraceRecorder

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS",
    "TraceEvent",
    "TraceRecorder",
    "EntryHealth",
    "QuantHealth",
    "shift_drift",
    "ServeRecorder",
]
