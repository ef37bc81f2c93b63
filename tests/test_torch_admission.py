"""The port's fair admission and its server's fault handling, held against
the JAX package's.

* ``parse_tenants`` parses the same specs and rejects the same garbage.
* ``FairAdmission`` grants in the same order as the JAX package's for the
  same scripted arrivals, releases and resizes across tenants, weights,
  priorities and queue bounds, and rejects the same waiters (hypothesis
  over scripts; exact).
* The server (one replica, the synthetic f32 model of
  ``test_torch_server.py``): a deadline that expires in the queue is 504, one
  that expires mid-stream a terminal SSE event, a non-finite one 400; an
  oversized body 413; a full queue 429 with Retry-After in [1, 1 +
  jitter]; a client disconnect (the ``server.send`` site) leaves no row
  joined; tenant and priority fields and their defaults; the seed pinned
  once; a row fault ends only its request (500); and a preempted victim
  resumes and streams exactly its uncontended completion.
"""

import http.client
import json
import threading
import time
import types
import urllib.error
import urllib.parse
import urllib.request

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from distributed_llama_tpu.server import admission as jadm

from distributed_llama_tpu_torch import telemetry as ttel
from distributed_llama_tpu_torch.engine import faults as tfaults
from distributed_llama_tpu_torch.server import admission as tadm
from distributed_llama_tpu_torch.server import api as tapi

from tests.test_torch_server import files, torch_state  # noqa: F401 (the fixture)


@pytest.fixture(autouse=True)
def _no_plan():
    tfaults.clear()
    yield
    tfaults.clear()


# ----------------------------------------------------------------------
# Tenant specs and grant order
# ----------------------------------------------------------------------


@pytest.mark.parametrize("spec", [None, "", "gold:weight=4,priority=10;free:weight=1",
                                  " a:queue=2 ; b:priority=-3,weight=2 ", "solo"])
def test_parse_tenants_equal(spec):
    assert {k: vars(v) for k, v in tadm.parse_tenants(spec).items()} == {
        k: vars(v) for k, v in jadm.parse_tenants(spec).items()}


@pytest.mark.parametrize("bad", ["gold:weight=0", "gold:wat=1", ":weight=1", "a:weight=1;a:weight=2",
                                 "a:weight=x"])
def test_parse_tenants_rejects_the_same_garbage(bad):
    with pytest.raises(ValueError):
        jadm.parse_tenants(bad)
    with pytest.raises(ValueError):
        tadm.parse_tenants(bad)


def _settle(adm, started: int, order: list, rejected: list, timeout=10.0) -> None:
    """Wait until every started waiter is queued, granted and recorded, or
    rejected, and no grant is still waking its thread."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with adm._cond:
            queued = sum(len(q) for q in adm._queues.values())
            waking = adm._waiting - queued
            if waking == 0 and adm._waiting + len(order) + len(rejected) == started:
                return
        time.sleep(0.001)
    raise AssertionError("admission script did not settle")


def run_script(mod, tenants: str, queue_limit: int, ops: list) -> tuple:
    """Drive one FairAdmission (one slot, held by the script) through
    ``ops``: ("arrive", tenant, priority), ("release",) (the oldest granted
    holder, the script's own first) or ("resize", delta), settling after
    each. Returns (grant order, rejected arrivals, admitted/rejected
    totals)."""
    adm = mod.FairAdmission(1, tenants=mod.parse_tenants(tenants), queue_limit=queue_limit)
    adm.acquire("seed")
    order, rejected, holders = [], [], ["seed"]
    events, threads = {}, []

    def one(i, tenant, priority):
        try:
            adm.acquire(tenant, priority)
        except mod.AdmissionRejected:
            rejected.append(i)
            return
        order.append(i)
        holders.append(i)
        events[i].wait(30)
        adm.release()

    for op in ops:
        if op[0] == "arrive":
            i = len(threads)
            events[i] = threading.Event()
            threads.append(threading.Thread(target=one, args=(i, op[1], op[2]), daemon=True))
            threads[-1].start()
        elif op[0] == "release":
            if not holders:
                continue
            h = holders.pop(0)
            if h == "seed":
                adm.release()
            else:
                events[h].set()
                threads[h].join(timeout=10)
        else:
            try:
                adm.resize(op[1])
            except ValueError:
                pass
        _settle(adm, len(threads), order, rejected)
    # drain: hand every permit back until everyone queued is served
    capacity_ok = adm.n_slots > 0
    while capacity_ok and holders:
        h = holders.pop(0)
        if h == "seed":
            adm.release()
        else:
            events[h].set()
            threads[h].join(timeout=10)
        _settle(adm, len(threads), order, rejected)
    for e in events.values():
        e.set()
    return order, sorted(rejected), dict(adm.admitted_total), dict(adm.rejected_total)


_op = st.one_of(
    st.tuples(st.just("arrive"), st.sampled_from(["a", "b", "c", "d"]), st.sampled_from([0, 0, 1, 5])),
    st.tuples(st.just("release")),
    st.tuples(st.just("resize"), st.sampled_from([-1, 1])),
)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(ops=st.lists(_op, min_size=1, max_size=14), queue_limit=st.integers(0, 6),
       tenants=st.sampled_from(["", "a:weight=3;b:weight=1", "a:weight=2,queue=1;c:priority=5",
                                "b:queue=0;d:weight=4"]))
def test_grant_order_equal_jax(ops, queue_limit, tenants):
    """The same scripted arrivals, releases and resizes: the same grants in
    the same order, the same rejected waiters, the same per-tenant totals."""
    want = run_script(jadm, tenants, queue_limit, ops)
    assert run_script(tadm, tenants, queue_limit, ops) == want


def test_weighted_shares_and_priority_first_equal_jax():
    """Saturated weight-3 vs weight-1 tenants grant 3:1 in every window,
    and a later high-priority arrival goes first, in both packages."""
    ops = [("arrive", "a", 0)] * 8 + [("arrive", "b", 0)] * 4 + [("arrive", "c", 5)] + [("release",)] * 13
    want = run_script(jadm, "a:weight=3", 100, ops)
    got = run_script(tadm, "a:weight=3", 100, ops)
    assert got == want
    order = [("a" if i < 8 else "b" if i < 12 else "c") for i in got[0]]
    assert order[0] == "c" and order[1:5].count("a") == 3


def test_queue_deadline_drain_and_registry_cap():
    adm = tadm.FairAdmission(1, queue_limit=4, max_tenants=2)
    adm.acquire("a")
    t0 = time.monotonic()
    with pytest.raises(tapi.DeadlineExceeded):
        adm.acquire("b", deadline=time.monotonic() + 0.1)
    assert time.monotonic() - t0 < 5 and adm.waiting() == 0
    assert [adm.resolve(f"churn-{i}") for i in range(3)] == ["default"] * 3  # "a" and "b" filled the registry
    assert not adm.drain_wait(0.05)
    adm.release()
    assert adm.drain_wait(1.0)
    adm.begin_drain()
    with pytest.raises(tadm.ServerDraining):
        adm.acquire("a")


# ----------------------------------------------------------------------
# The server
# ----------------------------------------------------------------------


def _serve(state):
    server, _ = tapi.make_server(types.SimpleNamespace(host="127.0.0.1", port=0), state=state)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def post_raw(url, body: dict, timeout=60):
    req = urllib.request.Request(url + "/v1/chat/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read().decode()
            return r.status, dict(r.headers), (json.loads(raw) if not body.get("stream") else raw)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _sse_events(raw: str) -> list:
    return [c[len("data: "):] for c in raw.split("\r\n\r\n") if c.startswith("data: ")]


MSG = [{"role": "user", "content": "hello"}]


def test_deadlines_504_sse_and_400(files):
    state = torch_state(files, parallel=1, admission_queue=4)
    server, url = _serve(state)
    try:
        state.admission.acquire("test")  # hold the only lane
        t0 = time.monotonic()
        status, _, body = post_raw(url, {"messages": MSG, "deadline_ms": 150})
        assert status == 504 and body["error"]["type"] == "deadline_exceeded"
        assert time.monotonic() - t0 < 30
    finally:
        state.admission.release()
        server.shutdown()
        server.server_close()
    for bad in (float("nan"), float("inf"), 0, -5, "soon"):
        with pytest.raises(tapi.BadRequest, match="deadline_ms|numeric"):
            state._parse({"messages": MSG, "deadline_ms": bad})
    # the SSE writer sleeps 4 s on its first event, so a 2 s deadline (room
    # for a loaded CPU's prefill) expires mid-stream: a terminal
    # deadline_exceeded event, then [DONE]
    tfaults.install(tfaults.parse("server.send:kind=delay,delay_ms=4000,count=1"))
    state = torch_state(files, parallel=2)
    tfaults.clear()
    server, url = _serve(state)
    try:
        status, _, raw = post_raw(url, {"messages": MSG, "stream": True, "deadline_ms": 2000, "max_tokens": 32})
        assert status == 200
        events = _sse_events(raw)
        assert events[-1] == "[DONE]"
        assert json.loads(events[-2])["error"]["type"] == "deadline_exceeded"
        assert not any(s._joined for s in state.batch._streams)
        assert post_raw(url, {"messages": MSG, "max_tokens": 4})[0] == 200
    finally:
        server.shutdown()
        server.server_close()


def test_413_429_retry_after_and_tenant_fields(files):
    state = torch_state(files, parallel=1, admission_queue=0, max_body_bytes=512,
                        tenants="gold:weight=4,priority=9")
    server, url = _serve(state)
    try:
        status, _, body = post_raw(url, {"messages": [{"role": "user", "content": "x" * 2048}]})
        assert status == 413 and body["error"]["type"] == "request_too_large"
        state.admission.acquire("test")
        try:
            status, headers, body = post_raw(url, {"messages": MSG})
            assert status == 429 and body["error"]["type"] == "overloaded"
            assert 1 <= int(headers["Retry-After"]) <= 1 + state.retry_after_jitter_s
        finally:
            state.admission.release()
        assert post_raw(url, {"messages": MSG, "max_tokens": 2, "tenant": "gold"})[0] == 200
    finally:
        server.shutdown()
        server.server_close()
    values = {state.retry_after() for _ in range(60)}
    assert values <= set(range(1, 2 + state.retry_after_jitter_s)) and len(values) > 1
    p = state._parse({"messages": MSG, "tenant": "gold", "priority": 7})
    assert (p["tenant"], p["priority"]) == ("gold", 7)
    p = state._parse({"messages": MSG})
    assert (p["tenant"], p["priority"], p["deadline_ms"]) == ("default", None, None)
    for bad in ({"tenant": ""}, {"tenant": 3}, {"tenant": "x" * 65}, {"tenant": "_integrity"},
                {"priority": "high"}):
        with pytest.raises(tapi.BadRequest):
            state._parse({"messages": MSG, **bad})
    assert state.admission.config("gold").priority == 9 and state.admission.config("other").priority == 0
    params = state._parse({"messages": MSG, "max_tokens": 2, "temperature": 0.8})
    state.complete({"messages": MSG}, lambda s: None, params=params)
    assert params["seed"] is not None  # pinned once, for every attempt


def test_disconnect_leaves_no_row_and_row_fault_ends_only_its_request(files):
    """The ``server.send`` disconnect site mid-stream: the row leaves the
    batch and the lane frees. Then a ``batch.row`` fault on row 1 of two
    concurrent requests: that request alone ends 500 (quarantined), the
    other completes with its fault-free text."""
    state = torch_state(files, parallel=2)
    sent = []

    def send_then_die(data):
        sent.append(data)
        raise BrokenPipeError("client went away")

    with pytest.raises(BrokenPipeError):
        state.complete({"stream": True, "max_tokens": 8, "messages": MSG}, send_then_die)
    assert sent and not any(s._joined for s in state.batch._streams)
    assert state.batch._pending is None and not state.batch._fetching and not any(s.busy for s in state.slots)
    bodies = [{"messages": [{"role": "user", "content": f"hello {i}"}], "max_tokens": 8} for i in range(2)]
    clean = [state.complete(b, lambda s: None)["choices"][0]["message"]["content"] for b in bodies]
    tfaults.install(tfaults.parse("server.send:kind=disconnect,count=1;batch.row:kind=nan,row=1,count=1"))
    state = torch_state(files, parallel=2)
    tfaults.clear()
    server, url = _serve(state)
    try:
        with pytest.raises((urllib.error.URLError, http.client.HTTPException, ConnectionError)):
            post_raw(url, {"messages": MSG, "stream": True, "max_tokens": 4})
        results = {}
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, post_raw(url, bodies[i])))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert sorted(r[0] for r in results.values()) == [200, 500]
        for i, (status, _, body) in results.items():
            if status == 200:
                assert body["choices"][0]["message"]["content"] == clean[i]
            else:
                assert "retired" in body["error"]["message"] and body["error"]["type"] == "server_error"
        assert post_raw(url, {"messages": MSG, "max_tokens": 2})[0] == 200
        state.batch.check_prefix()
    finally:
        server.shutdown()
        server.server_close()


class SseStream:
    """An incrementally read SSE completion (the preemption test observes a
    victim mid-stream)."""

    def __init__(self, url: str, body: dict):
        p = urllib.parse.urlsplit(url)
        self.conn = http.client.HTTPConnection(p.hostname, p.port, timeout=120)
        self.conn.request("POST", "/v1/chat/completions", json.dumps({**body, "stream": True}),
                          {"Content-Type": "application/json"})
        self.resp = self.conn.getresponse()
        assert self.resp.status == 200
        self.error_type = None

    def _events(self):
        for raw in self.resp:
            line = raw.strip()
            if not line.startswith(b"data: "):
                continue
            payload = line[len(b"data: "):]
            if payload == b"[DONE]":
                return
            yield json.loads(payload)

    def read_first_delta(self) -> str:
        for evt in self._events():
            if "error" in evt:
                self.error_type = evt["error"]["type"]
                return ""
            text = (evt["choices"][0].get("delta") or {}).get("content", "")
            if text:
                return text
        return ""

    def read_rest(self) -> str:
        parts = []
        for evt in self._events():
            if "error" in evt:
                self.error_type = evt["error"]["type"]
                break
            parts.append((evt["choices"][0].get("delta") or {}).get("content", ""))
        self.conn.close()
        return "".join(parts)


# every batched fetch sleeps this long, so the victims are still decoding
# when the preemptor arrives; a delay corrupts nothing
SLOW_DECODE = "batch.fetch:kind=delay,delay_ms=60,count=-1"
VICTIMS = [[{"role": "system", "content": "hello world " * 12}, {"role": "user", "content": f"story {i}"}]
           for i in range(2)]


@pytest.mark.parametrize("chaos", [False, True], ids=["requeue", "engine.preempt"])
def test_preempted_victim_resumes_bit_identical(files, chaos):
    """Two batch-tenant streams fill both lanes; a priority-5 ``gold``
    request arrives: one victim is evicted, the preemptor served first, and
    the victim re-runs from its prompt (a prefix-cache hit) with its sent
    deltas suppressed: both clients' full streams equal their uncontended
    completions. With the ``engine.preempt`` raise the victim alone ends
    with a typed error and the other stream is untouched."""
    ttel.reset()
    ttel.enable()
    try:
        tfaults.install(tfaults.parse(("engine.preempt:kind=raise,count=1;" if chaos else "") + SLOW_DECODE))
        state = torch_state(files, parallel=2, admission_queue=8, tenants="gold:weight=2,priority=5")
        tfaults.clear()
        server, url = _serve(state)
        try:
            want = []
            for m in VICTIMS:
                status, _, body = post_raw(url, {"messages": m, "max_tokens": 40})
                assert status == 200 and body["usage"]["completion_tokens"] >= 24
                want.append(body["choices"][0]["message"]["content"])
            streams = [SseStream(url, {"messages": m, "max_tokens": 40}) for m in VICTIMS]
            firsts = [s.read_first_delta() for s in streams]
            assert all(firsts)  # both victims are mid-decode
            status, _, _ = post_raw(url, {"messages": MSG, "max_tokens": 2, "tenant": "gold"})
            assert status == 200
            texts = [first + s.read_rest() for s, first in zip(streams, firsts)]
            outcomes = [(s.error_type, t) for s, t in zip(streams, texts)]
            text = ttel.prometheus_text()
        finally:
            server.shutdown()
            server.server_close()
            state.batch.close()
        if chaos:
            assert state.batch.preempted_total == 0
            assert sorted(e or "" for e, _ in outcomes) == ["", "server_error"], outcomes
            assert [t for (e, t), w in zip(outcomes, want) if e is None] == [w for (e, _), w in
                                                                               zip(outcomes, want) if e is None]
            assert "dllama_preempted_requeued_total 0" in text
        else:
            assert state.batch.preempted_total == 1
            assert outcomes == [(None, w) for w in want]
            assert "dllama_preempted_requeued_total 1" in text and "dllama_preemptions_total 1" in text
            assert 'dllama_tenant_admitted_total{tenant="gold"} 1' in text
            assert 'dllama_tenant_active{tenant="default"} 0' in text
        state.batch.check_prefix()
    finally:
        ttel.disable()
        ttel.reset()
