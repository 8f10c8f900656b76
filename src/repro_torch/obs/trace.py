"""Request lifecycle tracing: per-uid spans with monotonic step indices.

Port of ``repro.obs.trace`` (pure Python, nearly verbatim): the same
events, the same :meth:`TraceRecorder.signature` and the same Chrome
export, so a trace of the port's engine compares with the JAX engine's
event for event.

Span model: every request owns one outer ``request`` span
bracketing its whole lifetime, with nested phase spans

    queued -> [admitted] prefill (-> prefill-chunk* instants) -> decode
           -> spec-round*/preempt/resume* -> terminal (status on the E)

Begin/End events always nest (``end`` auto-closes dangling inner spans),
so the stream renders directly in Perfetto / chrome://tracing via
:meth:`TraceRecorder.to_chrome` — one pseudo-thread per uid, tid 0 for
scheduler-scope events (decode steps, fault injections).

Determinism contract: :meth:`TraceRecorder.signature` strips wall-clock
timestamps, leaving ``(uid, phase, kind, step, args)`` tuples — two runs
under the same seeded :class:`~repro_torch.serve.faults.FaultPlan` must
produce identical signatures (``tests/test_torch_obs.py``).
"""
from __future__ import annotations

import dataclasses
import json
import time

__all__ = ["TraceEvent", "TraceRecorder"]


@dataclasses.dataclass
class TraceEvent:
    uid: object          # request uid; None = scheduler-scope
    phase: str           # span / instant name
    kind: str            # "B" begin, "E" end, "I" instant
    step: int            # scheduler iteration when emitted
    t: float             # seconds since the recorder's origin
    args: dict = dataclasses.field(default_factory=dict)

    def signature(self):
        """Timestamp-free identity, for determinism comparisons."""
        return (self.uid, self.phase, self.kind, self.step,
                tuple(sorted(self.args.items())))


class TraceRecorder:
    """Bounded in-memory event log; past capacity events are *counted*
    as dropped, never silently lost."""

    def __init__(self, max_events: int = 200_000):
        self.max_events = int(max_events)
        self.reset()

    def reset(self) -> None:
        self.events: list[TraceEvent] = []
        self.dropped = 0
        self._t0 = time.perf_counter()
        self._open: dict = {}  # uid -> stack of open phase names

    def now(self) -> float:
        return time.perf_counter() - self._t0

    # ------------------------------ emit ------------------------------

    def _emit(self, uid, phase, kind, step, args) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(TraceEvent(uid, phase, kind, int(step),
                                      self.now(), args))

    def begin(self, uid, phase, step, **args) -> None:
        self._open.setdefault(uid, []).append(phase)
        self._emit(uid, phase, "B", step, args)

    def end(self, uid, phase, step, **args) -> None:
        """Close ``phase``; dangling inner spans are closed first so B/E
        always nest.  No-op if ``phase`` is not open for ``uid``."""
        stack = self._open.get(uid) or []
        if phase not in stack:
            return
        while stack[-1] != phase:
            self._emit(uid, stack.pop(), "E", step, {})
        stack.pop()
        self._emit(uid, phase, "E", step, args)

    def end_open(self, uid, step, keep=()) -> None:
        """Close every open span of ``uid`` except the (outer) ``keep``."""
        stack = self._open.get(uid) or []
        while stack and stack[-1] not in keep:
            self._emit(uid, stack.pop(), "E", step, {})

    def instant(self, uid, phase, step, **args) -> None:
        self._emit(uid, phase, "I", step, args)

    # ----------------------------- queries -----------------------------

    def open_spans(self, uid):
        return tuple(self._open.get(uid) or ())

    def complete(self, uid) -> bool:
        return not self._open.get(uid)

    def span_tree(self, uid):
        """Nested span tree for one uid: ``{phase, begin_step, t0, args,
        children, events[, end_step, t1]}``; instants attach to their
        enclosing span.  Returns the outer ``request`` node (or None)."""
        root = {"phase": "<root>", "children": [], "events": [], "args": {}}
        stack = [root]
        for ev in self.events:
            if ev.uid != uid:
                continue
            if ev.kind == "B":
                node = {"phase": ev.phase, "begin_step": ev.step,
                        "t0": ev.t, "args": dict(ev.args),
                        "children": [], "events": []}
                stack[-1]["children"].append(node)
                stack.append(node)
            elif ev.kind == "E":
                if len(stack) > 1:
                    node = stack.pop()
                    node["end_step"] = ev.step
                    node["t1"] = ev.t
                    node["args"].update(ev.args)
            else:
                stack[-1]["events"].append({"phase": ev.phase,
                                            "step": ev.step, "t": ev.t,
                                            "args": dict(ev.args)})
        return root["children"][0] if root["children"] else None

    def terminal_status(self, uid):
        """Status recorded on the closed outer ``request`` span, if any."""
        tree = self.span_tree(uid)
        if tree is None or "t1" not in tree:
            return None
        return tree["args"].get("status")

    def signature(self):
        return [ev.signature() for ev in self.events]

    # ----------------------------- exports -----------------------------

    def to_json(self):
        return {"dropped": self.dropped,
                "events": [dataclasses.asdict(ev) for ev in self.events]}

    def to_chrome(self):
        """Chrome trace-event list: pid 1, one pseudo-thread per uid
        (first-seen order), tid 0 for scheduler-scope events."""
        tids: dict = {}
        out = [{"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
                "args": {"name": "repro.serve"}},
               {"name": "thread_name", "ph": "M", "pid": 1, "tid": 0,
                "args": {"name": "scheduler"}}]

        def tid(uid):
            if uid is None:
                return 0
            if uid not in tids:
                tids[uid] = len(tids) + 1
                out.append({"name": "thread_name", "ph": "M", "pid": 1,
                            "tid": tids[uid],
                            "args": {"name": f"req {uid}"}})
            return tids[uid]

        kinds = {"B": "B", "E": "E", "I": "i"}
        for ev in self.events:
            row = {"name": ev.phase, "ph": kinds[ev.kind], "pid": 1,
                   "tid": tid(ev.uid), "ts": ev.t * 1e6,
                   "args": {"step": ev.step, **ev.args}}
            if ev.kind == "I":
                row["s"] = "t"  # thread-scoped instant
            out.append(row)
        return out

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    def save_chrome(self, path) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.to_chrome(),
                       "displayTimeUnit": "ms"}, f)
