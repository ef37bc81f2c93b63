"""Lightweight span tracer: nested wall-time spans in a ring buffer, with
Chrome trace-event JSON export.

The port's copy of the JAX package's ``telemetry/tracer.py``. Spans mark
the engine's phase structure (prefill, decode chunk dispatch, chunk fetch)
on a wall-clock timeline — the offline
complement to the registry's aggregates. The buffer is a fixed-size ring
(old spans fall off; a long-running server never grows), and the export is
the Chrome ``traceEvents`` format, loadable in chrome://tracing or
https://ui.perfetto.dev.

Enter/exit costs two ``perf_counter`` calls plus one deque append and never
synchronizes the device: around an eager PyTorch dispatch a span measures
the host's issue time, and the wait on the card shows up in the span
around the fetch that waits for it. The disabled path never reaches this
module (the telemetry facade hands out a
shared no-op span instead).
"""

from __future__ import annotations

import collections
import json
import threading
import time


class SpanEvent:
    __slots__ = ("name", "ts_us", "dur_us", "tid", "depth", "args")

    def __init__(self, name, ts_us, dur_us, tid, depth, args):
        self.name = name
        self.ts_us = ts_us
        self.dur_us = dur_us
        self.tid = tid
        self.depth = depth
        self.args = args


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_depth")

    def __init__(self, tracer: "SpanTracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        local = self._tracer._local
        self._depth = getattr(local, "depth", 0)
        local.depth = self._depth + 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer._local.depth = self._depth
        self._tracer._record(
            SpanEvent(
                self.name,
                (self._t0 - self._tracer._epoch) * 1e6,
                (t1 - self._t0) * 1e6,
                threading.get_ident(),
                self._depth,
                self.args,
            )
        )
        return False


class _NullSpan:
    """Shared no-op span for disabled telemetry: zero state, zero recording."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class SpanTracer:
    def __init__(self, capacity: int = 65536):
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._events: collections.deque[SpanEvent] = collections.deque(maxlen=capacity)

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def _record(self, ev: SpanEvent) -> None:
        with self._lock:
            self._events.append(ev)

    def events(self) -> list[SpanEvent]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def chrome_trace(self) -> dict:
        """The buffered spans as a Chrome trace-event JSON object."""
        trace_events = [
            {
                "name": ev.name,
                "ph": "X",
                "ts": ev.ts_us,
                "dur": ev.dur_us,
                "pid": 0,
                "tid": ev.tid,
                "args": {**ev.args, "depth": ev.depth},
            }
            for ev in self.events()
        ]
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path
