"""The open-loop HTTP client: fire each scheduled request at its instant,
stream the SSE response, measure TTFT / TPOT / E2E.

The port's copy of the JAX package's ``loadgen/runner.py``, whole.

Open-loop is the point (Schroeder et al.'s closed-vs-open distinction the
serving literature leans on): a closed-loop client waits for completions
before sending more, so server queueing throttles the offered load and the
measured tail flatters the system precisely when it is collapsing. Here
arrivals come from the SCHEDULE — a slow server just accumulates in-flight
requests (bounded by ``max_inflight``; arrivals past the bound are
recorded as ``dropped``, never silently skipped).

Measurement points, per request:
* **TTFT** — request sent → first SSE delta with content (prefill + queue
  wait + first token; the user-visible "it started" latency).
* **TPOT** — mean gap between content deltas after the first (the decode
  cadence; one delta ≈ one token on the greedy path).
* **E2E** — request sent → terminal ``[DONE]`` (or error/failure).

Everything uses ``time.monotonic``/``Stopwatch`` — wall-clock steps must
not corrupt latency samples.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import threading
import time
import urllib.parse

from distributed_llama_tpu_torch.loadgen.workload import ScheduledRequest

# terminal classification buckets the report aggregates (docs/SERVING.md)
OUTCOMES = (
    "completed", "rejected_429", "draining_503", "deadline_504",
    "error", "dropped",
)


@dataclasses.dataclass
class RequestResult:
    """One arrival's measured outcome. ``outcome`` is one of
    :data:`OUTCOMES`; latency fields are None when the phase was never
    reached (a 429 has no TTFT)."""

    index: int
    tenant: str
    at_s: float
    body_key: str
    prefix_id: int
    outcome: str
    status: int | None = None
    ttft_ms: float | None = None
    tpot_ms: float | None = None
    e2e_ms: float | None = None
    n_deltas: int = 0
    content: str = ""
    error_type: str | None = None
    retry_after: int | None = None
    sched_lag_ms: float = 0.0  # actual fire time - scheduled time


def _classify_status(status: int) -> str:
    if status == 429:
        return "rejected_429"
    if status == 503:
        return "draining_503"
    if status == 504:
        return "deadline_504"
    return "error"


def _run_one(
    host: str, port: int, req: ScheduledRequest, timeout_s: float,
    lag_ms: float,
) -> RequestResult:
    """Execute one streaming completion over a fresh connection (each
    arrival is an independent client; connection reuse would serialize
    the open loop)."""
    res = RequestResult(
        index=req.index, tenant=req.tenant, at_s=req.at_s,
        body_key=req.body_key, prefix_id=req.prefix_id, outcome="error",
        sched_lag_ms=round(lag_ms, 3),
    )
    t0 = time.monotonic()
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        conn.request(
            "POST", "/v1/chat/completions", json.dumps(req.body),
            {"Content-Type": "application/json"},
        )
        resp = conn.getresponse()
        res.status = resp.status
        if resp.status != 200:
            ra = resp.getheader("Retry-After")
            res.retry_after = int(ra) if ra and ra.isdigit() else None
            try:
                err = json.loads(resp.read())
                res.error_type = err.get("error", {}).get("type")
            except (ValueError, OSError):
                pass
            res.outcome = _classify_status(resp.status)
            res.e2e_ms = (time.monotonic() - t0) * 1000.0
            return res
        # SSE: frames are "data: <payload>\r\n\r\n"; read line-wise so the
        # first-delta timestamp is taken the moment it arrives
        first_t = last_t = None
        done = False
        parts: list[str] = []
        for raw in resp:
            line = raw.strip()
            if not line.startswith(b"data: "):
                continue
            payload = line[len(b"data: "):]
            if payload == b"[DONE]":
                done = True
                break
            try:
                evt = json.loads(payload)
            except ValueError:
                res.error_type = "bad_sse_json"
                break
            if "error" in evt:
                res.error_type = evt["error"].get("type", "server_error")
                break
            choice = (evt.get("choices") or [{}])[0]
            text = (choice.get("delta") or {}).get("content", "")
            if text:
                now = time.monotonic()
                if first_t is None:
                    first_t = now
                last_t = now
                res.n_deltas += 1
                parts.append(text)
        res.e2e_ms = (time.monotonic() - t0) * 1000.0
        res.content = "".join(parts)
        if first_t is not None:
            res.ttft_ms = (first_t - t0) * 1000.0
            if res.n_deltas > 1:
                res.tpot_ms = (
                    (last_t - first_t) * 1000.0 / (res.n_deltas - 1)
                )
        if done and res.error_type is None:
            res.outcome = "completed"
        elif res.error_type == "deadline_exceeded":
            res.outcome = "deadline_504"  # mid-stream expiry: same class
        else:
            res.outcome = "error"
        return res
    except OSError as e:
        res.error_type = f"transport:{type(e).__name__}"
        res.e2e_ms = (time.monotonic() - t0) * 1000.0
        return res
    finally:
        conn.close()


def warm_server(url: str, schedule, n: int = 2, timeout_s: float = 300.0) -> int:
    """Fire ``n`` SEQUENTIAL unmeasured requests (bodies from the schedule
    head) so jit compiles and cold caches land outside the measured
    window. Returns how many completed."""
    if not schedule:
        return 0
    parsed = urllib.parse.urlsplit(url)
    ok = 0
    for i in range(n):
        req = schedule[i % len(schedule)]
        r = _run_one(parsed.hostname, parsed.port, req, timeout_s, 0.0)
        ok += r.outcome == "completed"
    return ok


def run_schedule(
    url: str,
    schedule: list[ScheduledRequest],
    max_inflight: int = 128,
    timeout_s: float = 120.0,
) -> tuple[list[RequestResult], float]:
    """Drive ``schedule`` open-loop against ``url``. Returns (results in
    schedule order, wall seconds). Arrivals that would exceed
    ``max_inflight`` concurrent requests are recorded as ``dropped`` —
    bounded client memory, never a silent hole in the accounting."""
    parsed = urllib.parse.urlsplit(url)
    host, port = parsed.hostname, parsed.port
    results: list[RequestResult | None] = [None] * len(schedule)
    inflight = threading.Semaphore(max_inflight)
    threads: list[threading.Thread] = []
    t0 = time.monotonic()

    def fire(req: ScheduledRequest, lag_ms: float):
        try:
            results[req.index] = _run_one(host, port, req, timeout_s, lag_ms)
        finally:
            inflight.release()

    for req in schedule:
        now = time.monotonic() - t0
        if req.at_s > now:
            time.sleep(req.at_s - now)
        lag_ms = max(0.0, (time.monotonic() - t0 - req.at_s) * 1000.0)
        if not inflight.acquire(blocking=False):
            results[req.index] = RequestResult(
                index=req.index, tenant=req.tenant, at_s=req.at_s,
                body_key=req.body_key, prefix_id=req.prefix_id,
                outcome="dropped", sched_lag_ms=round(lag_ms, 3),
            )
            continue
        th = threading.Thread(
            target=fire, args=(req, lag_ms), name=f"loadgen-{req.index}",
            daemon=True,
        )
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=timeout_s)
    wall_s = time.monotonic() - t0
    out: list[RequestResult] = []
    for req, r in zip(schedule, results):
        if r is None:  # a join timeout: the thread is stuck in transport
            r = RequestResult(
                index=req.index, tenant=req.tenant, at_s=req.at_s,
                body_key=req.body_key, prefix_id=req.prefix_id,
                outcome="error", error_type="client_timeout",
            )
        out.append(r)
    return out, wall_s
