"""One recorder for everything the serving engine emits.

Port of ``repro.obs.recorder`` (host Python, the same hooks, metric names
and trace events).  :class:`ServeRecorder` bundles the lifecycle trace
(:mod:`repro_torch.obs.trace`), the metrics registry
(:mod:`repro_torch.obs.metrics`) and quantization-health telemetry
(:mod:`repro_torch.obs.health`) behind the hook surface both serve
schedulers call.  Every engine-facing hook is a no-op when disabled, so
the hot loop pays one attribute test per call site, and no hook launches
device work: step durations arrive from the engine, taken after the
step's tokens reached the host, and only a guard trip reads the cache
(:meth:`~repro_torch.obs.health.QuantHealth.attribute_trip`).

``Engine.last_stats`` is untouched either way: it remains the
backwards-compatible snapshot view, while the recorder holds the
per-request timing, distributions and health counters that a single dict
of totals cannot express.
"""
from __future__ import annotations

import json

from .health import QuantHealth
from .metrics import DEFAULT_LATENCY_BUCKETS, MetricsRegistry
from .trace import TraceRecorder

__all__ = ["ServeRecorder"]

# accepted-length histogram upper bounds: spec_k <= 6 in every config here
_ACCEPT_BUCKETS = tuple(float(i) for i in range(8))

# last_stats totals mirrored into the registry at serve_end
_END_COUNTERS = ("prefill_tokens", "decode_tokens", "cancelled",
                 "deadline_expired", "quarantined", "numeric_faults",
                 "guard_checks", "fallback_steps", "cow_splits",
                 "chunk_steps", "stalled_decode_steps", "admission_blocked")
_END_GAUGES = ("decode_tps", "occupancy", "kv_bytes_per_token",
               "block_utilization", "block_peak_used", "shared_blocks_peak",
               "max_concurrent")


class ServeRecorder:
    """Unified trace + metrics + health recorder for ``Engine.serve``."""

    def __init__(self, enabled: bool = False, max_events: int = 200_000,
                 health_probe: str = "e5m7"):
        self.enabled = bool(enabled)
        self.trace = TraceRecorder(max_events=max_events)
        self.metrics = MetricsRegistry()
        self.health = QuantHealth(probe=health_probe)
        self.requests: dict = {}
        self.scheduler = None

    def reset(self) -> None:
        self.trace.reset()
        self.metrics = MetricsRegistry()
        self.health.reset()
        self.requests = {}

    # ----------------------- scheduler lifecycle -----------------------

    def serve_start(self, scheduler: str, queued=()) -> None:
        if not self.enabled:
            return
        self.reset()
        self.scheduler = scheduler
        for uid, prompt_len in queued:
            self.queued(uid, 0, prompt_len)

    def serve_end(self, stats: dict) -> None:
        """Mirror the last_stats totals into the registry (the dict stays
        the engine's backwards-compatible snapshot view)."""
        if not self.enabled:
            return
        for key in _END_COUNTERS:
            if key in stats:
                self.metrics.counter(f"serve_{key}_total").inc(stats[key])
        for key in _END_GAUGES:
            if key in stats:
                self.metrics.gauge(f"serve_{key}").set(stats[key])
        if stats.get("prefix_lookups"):
            self.metrics.gauge("serve_prefix_hit_rate").set(
                stats.get("prefix_hit_blocks", 0) / stats["prefix_lookups"])

    # ----------------------- request lifecycle -----------------------

    def queued(self, uid, step, prompt_len=0) -> None:
        if not self.enabled:
            return
        self.requests.setdefault(uid, {"queued_t": self.trace.now(),
                                       "first_t": None, "end_t": None,
                                       "status": None, "tokens": 0})
        self.trace.begin(uid, "request", step, prompt_len=int(prompt_len))
        self.trace.begin(uid, "queued", step)

    def admitted(self, uid, step, prompt_len=0, resumed=False,
                 chunked=False) -> None:
        if not self.enabled:
            return
        self.metrics.counter("serve_admissions_total").inc()
        if resumed:
            self.metrics.counter("serve_resumed_total").inc()
            self.trace.instant(uid, "resume", step)
        self.trace.end(uid, "queued", step)
        args = {"prompt_len": int(prompt_len)}
        if chunked:
            args["chunked"] = 1
        self.trace.begin(uid, "prefill", step, **args)

    def chunk(self, uid, step, tokens, done, total) -> None:
        if not self.enabled:
            return
        self.metrics.counter("serve_prefill_chunks_total").inc()
        self.trace.instant(uid, "prefill-chunk", step, tokens=int(tokens),
                           done=int(done), total=int(total))

    def first_token(self, uid, step) -> None:
        if not self.enabled:
            return
        rq = self.requests.get(uid)
        if rq is not None and rq["first_t"] is None:
            rq["first_t"] = self.trace.now()
            self.metrics.histogram(
                "serve_ttft_seconds",
                help="queued -> first token").observe(
                    rq["first_t"] - rq["queued_t"])
        self.trace.end(uid, "prefill", step)
        self.trace.begin(uid, "decode", step)

    def preempted(self, uid, step) -> None:
        if not self.enabled:
            return
        self.metrics.counter("serve_preemptions_total").inc()
        self.trace.end_open(uid, step, keep=("request",))
        self.trace.instant(uid, "preempt", step)
        self.trace.begin(uid, "queued", step)

    def terminal(self, uid, status, step, tokens=0) -> None:
        if not self.enabled:
            return
        rq = self.requests.setdefault(
            uid, {"queued_t": self.trace.now(), "first_t": None,
                  "end_t": None, "status": None, "tokens": 0})
        rq["end_t"] = self.trace.now()
        rq["status"] = status
        rq["tokens"] = int(tokens)
        self.metrics.counter("serve_requests_total", status=status).inc()
        self.trace.end_open(uid, step, keep=("request",))
        self.trace.end(uid, "request", step, status=status)

    # --------------------------- step-level ---------------------------

    def decode_step(self, step, lanes, dur_s) -> None:
        if not self.enabled:
            return
        self.metrics.counter("serve_decode_steps_total").inc()
        self.metrics.histogram(
            "serve_decode_step_seconds",
            help="wall time of one pool decode step").observe(dur_s)
        self.trace.instant(None, "decode-step", step, lanes=int(lanes))

    def spec_round(self, step, keeps) -> None:
        if not self.enabled:
            return
        self.metrics.counter("serve_spec_rounds_total").inc()
        h = self.metrics.histogram("serve_spec_accepted",
                                   buckets=_ACCEPT_BUCKETS,
                                   help="accepted tokens per spec round")
        for k in keeps:
            h.observe(k)
        self.trace.instant(None, "spec-round", step, lanes=len(keeps))

    def spec_summary(self, stats: dict) -> None:
        if not self.enabled:
            return
        if "mean_accepted" in stats:
            self.metrics.gauge("serve_spec_mean_accepted").set(
                stats["mean_accepted"])

    def pool_sample(self, step, alloc=None, prefix=None) -> None:
        if not self.enabled:
            return
        if alloc is not None:
            for key, val in alloc.stats().items():
                self.metrics.gauge(f"serve_block_pool_{key}").set(val)
        if prefix is not None:
            self.metrics.gauge("serve_prefix_hit_rate").set(prefix.hit_rate)

    # --------------------- faults / numeric health ---------------------

    def guard_trip(self, uids, step, cache=None) -> None:
        if not self.enabled or not uids:
            return
        self.metrics.counter("serve_guard_trips_total").inc(len(uids))
        entries = self.health.attribute_trip(cache, n=len(uids))
        where = ",".join(entries) if entries else "unattributed"
        for uid in uids:
            self.trace.instant(uid, "guard-trip", step, entries=where)

    def fault_injected(self, kind, index) -> None:
        if not self.enabled:
            return
        self.metrics.counter("serve_faults_injected_total", kind=kind).inc()
        self.trace.instant(None, f"fault-{kind}", index)

    # ------------------------ summaries / export ------------------------

    def request_summary(self) -> dict:
        """Per-uid ``{status, ttft_s, total_s, tokens, tok_s}``."""
        out = {}
        for uid, rq in self.requests.items():
            t0, ft, t1 = rq["queued_t"], rq["first_t"], rq["end_t"]
            ttft = ft - t0 if ft is not None else None
            total = t1 - t0 if t1 is not None else None
            decode_s = (t1 - ft) if (ft is not None and t1 is not None) else 0
            out[uid] = {"status": rq["status"], "ttft_s": ttft,
                        "total_s": total, "tokens": rq["tokens"],
                        "tok_s": rq["tokens"] / decode_s if decode_s > 0
                        else 0.0}
        return out

    def complete_spans(self, request_status: dict) -> bool:
        """Every uid's span tree closed, with the terminal status on the
        outer ``request`` span matching ``last_stats['request_status']``."""
        for uid, status in request_status.items():
            if self.trace.open_spans(uid):
                return False
            if self.trace.terminal_status(uid) != status:
                return False
        return True

    def snapshot(self) -> dict:
        return {"scheduler": self.scheduler,
                "metrics": self.metrics.snapshot(),
                "health": self.health.snapshot(),
                "requests": {str(uid): summ for uid, summ
                             in self.request_summary().items()},
                "trace": {"events": len(self.trace.events),
                          "dropped": self.trace.dropped}}

    def save_metrics(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)

    def save_trace(self, path) -> None:
        self.trace.save_chrome(path)
