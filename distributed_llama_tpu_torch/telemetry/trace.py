"""Request-scoped tracing: one span tree per request.

The port's copy of the JAX package's ``telemetry/trace.py``. The ring
tracer answers "what is the engine doing" in aggregate; this module
answers "why was THIS request slow". A :class:`TraceContext` is created
per completion request at the HTTP front door and threaded through every
layer the request touches — the lane queue wait, the prefix-cache match,
the replica placement, the prefill, the shared batched decode dispatches
(each fanning out to a per-row child span), speculative verify, failover
and preemption replays, SSE sends — so the server can
assemble a complete per-request tree and serve it at
``GET /debug/trace/<request_id>`` (JSON, or Chrome trace-event format).
A preempted or failed-over request's re-run is a sibling attempt of the
same tree, tagged ``replayed``, its stage time folded into the ``replay``
stage, and each attempt carries the replica that served it.

Design constraints inherited from the telemetry contract:

* **Zero overhead off** — with telemetry disabled the serving layer never
  constructs a store, every stream's ``trace`` attribute stays ``None``,
  and each hook is one attribute check. The module-level :func:`span`
  helper returns a shared no-op context manager for a ``None`` context.
* **Bounded** — a context's event list is a ring (``MAX_EVENTS``); the
  store retains a bounded deque of finished traces plus the in-flight map.
* **Sampled at retention, not at recording** — every request records while
  telemetry is on (recording is a lock + list append per span), and the
  store decides at completion whether to KEEP the trace: a seeded
  Bernoulli draw at ``sample_rate``, overridden to always-keep when the
  request's TTFT crossed ``slow_ttft_s`` (the trace you want most is the
  slow one you didn't know to sample).

Attribution: the serving layer calls :meth:`TraceContext.add_stage` with
wall time measured around each stage boundary (queue / placement /
prefill / decode); stages recorded during a replayed attempt fold into
``replay``. The per-tenant ``dllama_ttft_seconds`` / ``dllama_tpot_seconds``
histograms and the ``dllama_request_stage_seconds`` breakdown are observed
from the same timestamps, so the server-side SLO surface and the trace
tree can never disagree about what they measured.
"""

from __future__ import annotations

import collections
import random
import threading
import time

MAX_EVENTS = 2048


class _TraceSpan:
    """Context manager recording one complete span on a TraceContext."""

    __slots__ = ("_ctx", "_name", "_args", "_t0")

    def __init__(self, ctx: "TraceContext", name: str, args: dict):
        self._ctx = ctx
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._ctx.add_span(
            self._name, self._t0, time.perf_counter() - self._t0, **self._args
        )
        return False


class _NullTraceSpan:
    """Shared no-op for untraced requests: zero state, zero recording."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_TRACE_SPAN = _NullTraceSpan()


def span(ctx: "TraceContext | None", name: str, **args):
    """``with trace.span(ctx, "queue_wait"):`` — records a span on ``ctx``,
    or nothing when the request is untraced (``ctx is None``)."""
    if ctx is None:
        return NULL_TRACE_SPAN
    return _TraceSpan(ctx, name, args)


class TraceContext:
    """One request's trace: events tagged with the attempt that recorded
    them (a failover replay is a NEW sibling attempt in the same tree),
    per-stage attribution accumulators, and the first/last-token
    timestamps TTFT/TPOT derive from."""

    __slots__ = (
        "request_id", "tenant", "_lock", "_t0", "attempt", "attempts",
        "events", "stages", "notes", "first_token_s", "last_token_s",
        "emitted", "e2e_s", "sampled",
    )

    def __init__(self, request_id: str, tenant: str):
        self.request_id = request_id
        self.tenant = tenant
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.attempt = 0
        # one dict per attempt; [-1] is the live one. ``replayed`` marks
        # attempts re-run after a replica loss / preemption requeue.
        self.attempts: list[dict] = []
        self.events: collections.deque = collections.deque(maxlen=MAX_EVENTS)
        self.stages: dict[str, float] = {}
        self.notes: dict = {}
        self.first_token_s: float | None = None
        self.last_token_s: float | None = None
        self.emitted = 0
        self.e2e_s: float | None = None
        self.sampled: bool | None = None

    # -- recording ------------------------------------------------------

    def begin_attempt(self, replayed: bool = False, replica: int | None = None):
        with self._lock:
            self.attempts.append(
                {
                    "replayed": bool(replayed),
                    "replica": replica,
                    "start_us": (time.perf_counter() - self._t0) * 1e6,
                }
            )
            self.attempt = len(self.attempts) - 1

    def set_replica(self, replica: int) -> None:
        """Stamp the live attempt with the replica that placement chose
        (placement resolves AFTER begin_attempt, so this back-fills)."""
        with self._lock:
            if not self.attempts:
                self.attempts.append(
                    {"replayed": False, "replica": None, "start_us": 0.0}
                )
            self.attempts[-1]["replica"] = int(replica)

    def add_span(self, name: str, t0: float, dur_s: float, **args) -> None:
        """Record a completed span (``t0`` an absolute ``perf_counter``
        instant; sub-perf_counter-resolution spans keep dur 0)."""
        with self._lock:
            if not self.attempts:
                self.attempts.append(
                    {"replayed": False, "replica": None, "start_us": 0.0}
                )
            self.events.append(
                {
                    "name": name,
                    "ts_us": (t0 - self._t0) * 1e6,
                    "dur_us": dur_s * 1e6,
                    "attempt": self.attempt,
                    "args": args,
                }
            )

    def span(self, name: str, **args) -> _TraceSpan:
        return _TraceSpan(self, name, args)

    def add_stage(self, stage: str, seconds: float) -> None:
        """Accumulate attribution; stages of a replayed attempt fold into
        ``replay`` (the breakdown stays queue/placement/prefill/decode
        for the attempt that actually streamed)."""
        with self._lock:
            if self.attempts and self.attempts[-1]["replayed"]:
                stage = "replay"
            self.stages[stage] = self.stages.get(stage, 0.0) + float(seconds)

    def note(self, **fields) -> None:
        with self._lock:
            self.notes.update(fields)

    def mark_token(self) -> None:
        """Per-emitted-token stamp (the serving layer's feed loop): the
        first stamp is TTFT, the spread of the rest is TPOT."""
        now = time.perf_counter() - self._t0
        with self._lock:
            if self.first_token_s is None:
                self.first_token_s = now
            self.last_token_s = now
            self.emitted += 1

    def finish(self) -> None:
        self.e2e_s = time.perf_counter() - self._t0

    # -- derived --------------------------------------------------------

    @property
    def ttft_s(self) -> float | None:
        return self.first_token_s

    @property
    def tpot_s(self) -> float | None:
        if (
            self.first_token_s is None
            or self.last_token_s is None
            or self.emitted < 2
        ):
            return None
        return (self.last_token_s - self.first_token_s) / (self.emitted - 1)

    # -- assembly -------------------------------------------------------

    def tree(self) -> dict:
        """The assembled span tree: request root → attempt siblings →
        recorded spans (docs/OBSERVABILITY.md "Request tracing")."""
        with self._lock:
            events = list(self.events)
            attempts = [dict(a) for a in self.attempts]
        nodes = []
        for i, meta in enumerate(attempts):
            spans = [e for e in events if e["attempt"] == i]
            end = max(
                (e["ts_us"] + e["dur_us"] for e in spans),
                default=meta["start_us"],
            )
            nodes.append(
                {
                    "name": "attempt",
                    "index": i,
                    "replayed": meta["replayed"],
                    "replica": meta["replica"],
                    "start_us": meta["start_us"],
                    "dur_us": end - meta["start_us"],
                    "spans": spans,
                }
            )
        return {
            "request_id": self.request_id,
            "tenant": self.tenant,
            "sampled": self.sampled,
            "e2e_s": self.e2e_s,
            "ttft_s": self.ttft_s,
            "tpot_s": self.tpot_s,
            "emitted": self.emitted,
            "stages": dict(self.stages),
            "notes": dict(self.notes),
            "attempts": nodes,
        }

    def chrome_trace(self) -> dict:
        """The same tree as Chrome trace-event JSON (chrome://tracing /
        ui.perfetto.dev): attempts map to tids, spans to complete events."""
        tree = self.tree()
        out = []
        for node in tree["attempts"]:
            out.append(
                {
                    "name": f"attempt{node['index']}"
                    + (" (replay)" if node["replayed"] else ""),
                    "ph": "X",
                    "ts": node["start_us"],
                    "dur": node["dur_us"],
                    "pid": 0,
                    "tid": node["index"],
                    "args": {"replayed": node["replayed"]},
                }
            )
            for e in node["spans"]:
                out.append(
                    {
                        "name": e["name"],
                        "ph": "X",
                        "ts": e["ts_us"],
                        "dur": e["dur_us"],
                        "pid": 0,
                        "tid": node["index"],
                        "args": dict(e["args"]),
                    }
                )
        return {"traceEvents": out, "displayTimeUnit": "ms"}


class RequestTraceStore:
    """Bounded retention for finished traces + the in-flight map.

    ``sample_rate`` draws from a seeded RNG (deterministic per process —
    trace retention must never depend on wall entropy in tests);
    ``slow_ttft_s`` always-keeps a trace whose TTFT crossed the threshold,
    whatever the draw said."""

    def __init__(
        self,
        capacity: int = 256,
        sample_rate: float = 1.0,
        slow_ttft_s: float = 1.0,
    ):
        self.capacity = max(1, int(capacity))
        self.sample_rate = min(1.0, max(0.0, float(sample_rate)))
        self.slow_ttft_s = float(slow_ttft_s)
        self._lock = threading.Lock()
        self._rng = random.Random(0)
        self._inflight: dict[str, TraceContext] = {}
        self._done: collections.deque = collections.deque(maxlen=self.capacity)
        self.started_total = 0
        self.kept_total = 0
        self.slow_kept_total = 0

    def begin(self, request_id: str, tenant: str) -> TraceContext:
        ctx = TraceContext(request_id, tenant)
        with self._lock:
            self.started_total += 1
            self._inflight[ctx.request_id] = ctx
        return ctx

    def finish(self, ctx: TraceContext) -> bool:
        """Close out ``ctx`` and decide retention. Returns True if kept."""
        ctx.finish()
        with self._lock:
            self._inflight.pop(ctx.request_id, None)
            keep = self._rng.random() < self.sample_rate
            slow = (
                ctx.ttft_s is not None
                and self.slow_ttft_s > 0
                and ctx.ttft_s >= self.slow_ttft_s
            )
            if slow and not keep:
                keep = True
                self.slow_kept_total += 1
            ctx.sampled = keep
            if keep:
                self.kept_total += 1
                self._done.append(ctx)
        return keep

    def get(self, request_id: str) -> TraceContext | None:
        with self._lock:
            for ctx in reversed(self._done):
                if ctx.request_id == request_id:
                    return ctx
            return self._inflight.get(request_id)

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "sample_rate": self.sample_rate,
                "slow_ttft_s": self.slow_ttft_s,
                "inflight": len(self._inflight),
                "retained": len(self._done),
                "started_total": self.started_total,
                "kept_total": self.kept_total,
                "slow_kept_total": self.slow_kept_total,
            }
