"""The port's API server held against the JAX package's.

Both ``ApiState``s serve the same synthetic f32 model (seq_len 1024) and
tokenizer (a ChatML template) with two batched lanes and the prefix cache
on. A greedy conversation runs through both: a plain JSON completion, the
same prompt again as SSE on the other lane (a prefix-cache hit), and a
follow-up turn that resumes the first lane's chat-prefix cache. Texts,
finish reasons and usage must be identical, with the default cache and with
``--cache-dtype i8 --spec-draft 3``. The port's HTTP handler then
serves /v1/models, an SSE stream, and a 429 past the admission queue. With
telemetry on, the same traffic moves the same counters in both servers,
also under tenants, a row fault, a preemption and a queued deadline.
"""

import json
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
import torch

import jax.numpy as jnp

from distributed_llama_tpu.engine import InferenceEngine as JaxEngine
from distributed_llama_tpu.server.api import ApiState as JaxApiState
from distributed_llama_tpu.tokenizer import Sampler as JaxSampler
from distributed_llama_tpu.tokenizer import Tokenizer as JaxTokenizer

from distributed_llama_tpu_torch.engine import InferenceEngine as TorchEngine
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file
from distributed_llama_tpu_torch.server import api as tapi
from distributed_llama_tpu_torch.tokenizer import Sampler as TorchSampler
from distributed_llama_tpu_torch.tokenizer import Tokenizer as TorchTokenizer

SPEC = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512, seq_len=1024)
CHATML = "{% for m in messages %}<|im_start|>{{m.role}}...{% endfor %}"
SYSTEM = "hello world " * 12
ARGS = dict(temperature=0.0, topp=0.9, topk=0, seed=1, chat_template=None, parallel=2, batch_decode=True,
            decode="device", decode_chunk=4, prefix_cache=True, kv_page_size=64, prefill_chunk=256)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_server")
    tsyn.write_synthetic_model(str(d / "m.m"), tsyn.tiny_spec(**SPEC), seed=2)
    data = tsyn.synthetic_tokenizer_data(vocab_size=SPEC["vocab_size"])
    data.chat_template = CHATML
    with open(d / "t.t", "wb") as f:
        write_tokenizer_file(f, data)
    return str(d / "m.m"), str(d / "t.t")


def torch_state(files, cache_dtype=None, tp=1, **overrides):
    model, tok = files
    args = types.SimpleNamespace(**{**ARGS, **overrides})
    engine = TorchEngine(model, dtype=torch.float32, device="cpu", cache_dtype=cache_dtype, tp=tp, allreduce="ring")
    sampler = TorchSampler(vocab_size=SPEC["vocab_size"], temperature=0.0, topp=0.9, seed=1)
    return tapi.ApiState(engine, TorchTokenizer.from_file(tok), sampler, args)


def conversation(state):
    """Three greedy completions; returns what each client saw."""
    msgs = [{"role": "system", "content": SYSTEM}, {"role": "user", "content": "hello"}]
    first = state.complete({"messages": msgs, "max_tokens": 8}, lambda s: None)
    chunks = []
    assert state.complete({"messages": msgs, "max_tokens": 8, "stream": True}, chunks.append) is None
    assert chunks[-1] == "[DONE]"
    events = [json.loads(c) for c in chunks[:-1]]
    sse = ("".join(e["choices"][0]["delta"]["content"] for e in events), events[-1]["choices"][0]["finish_reason"])
    follow = msgs + [{"role": "assistant", "content": first["choices"][0]["message"]["content"]},
                     {"role": "user", "content": "world"}]
    third = state.complete({"messages": follow, "max_tokens": 6}, lambda s: None)
    return [(r["choices"][0]["message"]["content"], r["choices"][0]["finish_reason"], r["usage"])
            for r in (first, third)] + [sse]


def test_api_state_matches_jax(monkeypatch, files):
    monkeypatch.setenv("DLT_FUSED_PAGED", "0")
    model, tok = files
    jstate = JaxApiState(JaxEngine(model, dtype=jnp.float32), JaxTokenizer.from_file(tok),
                         JaxSampler(vocab_size=SPEC["vocab_size"], temperature=0.0, topp=0.9, seed=1),
                         types.SimpleNamespace(**ARGS))
    want = conversation(jstate)
    state = torch_state(files)
    got = conversation(state)
    assert got == want
    assert want[0][2]["completion_tokens"] == 8 and want[0][2]["prompt_tokens"] > 64
    assert state.batch is not None and state.batch._prefix.hits >= 1  # the SSE rerun hit the cold run's pages
    assert state.slots[0].cache.items  # the follow-up resumed a lane's chat-prefix cache


@pytest.mark.parametrize("parallel", [2, 1])
def test_api_state_i8_spec_matches_jax(monkeypatch, files, parallel):
    """The same conversation with the int8 KV cache and speculative decoding
    (3 drafts per verify step) on both servers: batched lanes with the
    prefix cache, and one single-stream lane."""
    monkeypatch.setenv("DLT_FUSED_PAGED", "0")
    model, tok = files
    spec = dict(spec_draft=3, spec_ngram=3, parallel=parallel)
    jstate = JaxApiState(JaxEngine(model, dtype=jnp.float32, cache_dtype="i8"), JaxTokenizer.from_file(tok),
                         JaxSampler(vocab_size=SPEC["vocab_size"], temperature=0.0, topp=0.9, seed=1),
                         types.SimpleNamespace(**{**ARGS, **spec}))
    want = conversation(jstate)
    state = torch_state(files, cache_dtype="i8", **spec)
    got = conversation(state)
    assert got == want
    if parallel > 1:
        assert state.batch.spec_draft == 3 and state.batch.spec_row_steps > 0
        assert state.batch._prefix.hits >= 1
    else:
        assert state.batch is None and state.engine.cache_dtype == "i8"


def _post(url, body):
    req = urllib.request.Request(url + "/v1/chat/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=60)


@pytest.mark.parametrize("cache_dtype,spec_draft", [(None, 0), ("i8", 3)])
def test_concurrent_clients_get_their_single_stream_answers(files, cache_dtype, spec_draft):
    """Stress: 12 client threads (more than the cores) share 3 batched lanes
    through the bounded queue, with a short interpreter switch interval;
    every greedy answer equals the one a lone single-stream lane gives
    without speculation, and the prefix tree's invariants hold at the end.
    The second case serves with the int8 cache and speculative decoding,
    whose rows advance by a variable count per verify step."""
    prompts = [f"hello {'world ' * (i % 4)}{i}" for i in range(12)]

    def ask(state, i):
        body = {"messages": [{"role": "system", "content": SYSTEM}, {"role": "user", "content": prompts[i]}],
                "max_tokens": 5}
        return state.complete(body, lambda s: None)["choices"][0]["message"]["content"]

    lone = torch_state(files, cache_dtype=cache_dtype, parallel=1)
    want = [ask(lone, i) for i in range(len(prompts))]
    state = torch_state(files, cache_dtype=cache_dtype, parallel=3, admission_queue=len(prompts),
                        spec_draft=spec_draft)
    got: dict = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(i, ask(state, i))) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert [got.get(i) for i in range(len(prompts))] == want
    state.batch.check_prefix()
    assert state.batch._prefix.hits > 0 and not any(s.busy for s in state.slots)


def test_http_handler_sse_models_and_429(files):
    state = torch_state(files, parallel=1, admission_queue=0)
    assert state.batch is None  # one lane: an EngineStream
    server, _ = tapi.make_server(types.SimpleNamespace(host="127.0.0.1", port=0), state=state)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(url + "/v1/models", timeout=10) as r:
            assert json.loads(r.read())["data"][0]["id"] == "dl"
        body = {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 4, "stream": True}
        with _post(url, body) as r:
            assert r.headers["Content-Type"] == "text/event-stream"
            chunks = [c[len("data: "):] for c in r.read().decode().split("\r\n\r\n") if c.startswith("data: ")]
        assert chunks[-1] == "[DONE]"
        assert json.loads(chunks[-2])["choices"][0]["finish_reason"] in ("stop", "length")
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, {"messages": "nope"})
        assert e.value.code == 400
        slot = state._acquire_slot(body["messages"])  # the only lane is busy, the queue bound is 0
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url, {**body, "stream": False})
            assert e.value.code == 429 and e.value.headers["Retry-After"]
        finally:
            state._release_slot(slot)
        with _post(url, {**body, "stream": False}) as r:
            usage = json.loads(r.read())["usage"]
        assert usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"]
    finally:
        server.shutdown()
        server.server_close()


# ----------------------------------------------------------------------
# Telemetry: the same traffic moves the same counters in both servers
# ----------------------------------------------------------------------

DELTA_SERIES = (
    "dllama_tokens_generated_total",
    "dllama_prompt_tokens_total",
    "dllama_prefix_cache_hits_total",
    "dllama_prefix_cache_misses_total",
    'dllama_http_requests_total{route="/v1/chat/completions",status="200"}',
    "dllama_device_sampled_tokens_total",
    "dllama_spec_draft_tokens_total",
    "dllama_spec_accepted_tokens_total",
    "dllama_host_sampler_fallback_total",
    'dllama_ttft_seconds_count{tenant="default"}',
)


def _serve(state, make_handler):
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _scrape(url):
    from distributed_llama_tpu_torch.loadgen.report import parse_prometheus

    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
        return parse_prometheus(r.read().decode())


def _sequential_traffic(url):
    """Greedy and sampled, JSON and SSE, a prefix hit, a cache opt-out and
    a one-token completion, one request at a time."""
    msgs = [{"role": "system", "content": SYSTEM}, {"role": "user", "content": "hello"}]
    bodies = [
        {"messages": msgs, "max_tokens": 8},
        {"messages": msgs, "max_tokens": 8, "stream": True},
        {"messages": msgs[:1] + [{"role": "user", "content": "world hello world"}], "max_tokens": 7,
         "stream": True, "temperature": 0.8, "seed": 5},
        {"messages": msgs, "max_tokens": 6, "cache": "off"},
        {"messages": msgs, "max_tokens": 1, "stream": True},
    ]
    texts = []
    for body in bodies:
        with _post(url, body) as r:
            texts.append(r.read().decode())
    return texts


# the chaos case: tenants, a row fault, a preemption and a queued deadline
CHAOS_ARGS = dict(tenants="batch:weight=1,priority=0;live:weight=1,priority=1", admission_queue=8)
# every fetch sleeps 60 ms (the victims are still decoding when the live
# request arrives); row 1's first chunk comes back NaN
CHAOS_PLAN = "batch.row:kind=nan,row=1,count=1;batch.fetch:kind=delay,delay_ms=60,count=-1"
CHAOS_SERIES = tuple(
    [f'dllama_http_requests_total{{route="/v1/chat/completions",status="{c}"}}' for c in (200, 500, 504)]
    + ["dllama_rows_quarantined_total", "dllama_preemptions_total", "dllama_preempted_requeued_total",
       "dllama_deadline_exceeded_total", 'dllama_batch_retries_total{stage="fetch"}',
       'dllama_batch_retries_total{stage="dispatch"}', "dllama_watchdog_stalls_total"]
    + [f'dllama_{m}{{tenant="{t}"}}' for m in ("tenant_admitted_total", "ttft_seconds_count")
       for t in ("batch", "live")])


def _chaos_traffic(state, url):
    """Two concurrent batch requests (row 1's ends 500), two batch streams
    that a live arrival preempts one of (requeued, replayed), then a
    request whose deadline expires in the queue (504)."""
    import http.client
    import urllib.parse

    batch = [{"messages": [{"role": "system", "content": SYSTEM}, {"role": "user", "content": f"q {i}"}],
              "max_tokens": 8, "tenant": "batch"} for i in range(2)]
    statuses = []

    def post(body):
        try:
            with _post(url, body) as r:
                r.read()
                statuses.append(r.status)
        except urllib.error.HTTPError as e:
            statuses.append(e.code)

    threads = [threading.Thread(target=post, args=(b,)) for b in batch]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert sorted(statuses) == [200, 500]
    conns = []
    for i in range(2):
        p = urllib.parse.urlsplit(url)
        conn = http.client.HTTPConnection(p.hostname, p.port, timeout=120)
        conn.request("POST", "/v1/chat/completions", json.dumps(
            {"messages": [{"role": "user", "content": f"story {i}"}], "max_tokens": 40, "stream": True,
             "tenant": "batch"}), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        for line in resp:  # the first content delta: the victim is mid-decode
            if line.startswith(b"data: ") and b'"content": "' in line and b'"content": ""' not in line:
                break
        conns.append((conn, resp))
    post({"messages": [{"role": "user", "content": "quick"}], "max_tokens": 2, "tenant": "live"})
    for conn, resp in conns:
        assert b"error" not in resp.read()
        conn.close()
    state.admission.acquire("hold")
    state.admission.acquire("hold")
    try:
        post({"messages": [{"role": "user", "content": "late"}], "deadline_ms": 100, "tenant": "batch"})
    finally:
        state.admission.release()
        state.admission.release()
    assert statuses[2:] == [200, 504]


@pytest.mark.parametrize("spec_draft,chaos,tp", [(0, False, 1), (2, False, 1), (0, True, 1), (0, False, 2)],
                         ids=["0", "2", "chaos", "tp2"])
def test_metric_deltas_match_jax(monkeypatch, files, spec_draft, chaos, tp):
    """Telemetry on in both packages: the JAX ApiState and the port's take
    the same sequential requests over HTTP; the listed counters move by the
    same amounts (a difference is a fault of the port). The chaos case runs
    both with the same tenants and fault plan under ``_chaos_traffic``. The
    tp2 case serves tensor-parallel engines (2 ranks; the port's summed by
    K4/K5's arm), and the greedy conversation before the traffic gives both
    servers' clients the same texts, finish reasons and usage."""
    from distributed_llama_tpu import telemetry as jtel
    from distributed_llama_tpu.engine import faults as jfaults
    from distributed_llama_tpu.server.api import make_handler as jax_handler

    from distributed_llama_tpu_torch import telemetry as ttel
    from distributed_llama_tpu_torch.engine import faults as tfaults

    monkeypatch.setenv("DLT_FUSED_PAGED", "0")
    model, tok = files
    extra = CHAOS_ARGS if chaos else {}
    series = CHAOS_SERIES if chaos else DELTA_SERIES
    deltas, convs = [], []
    for tel, faults in ((jtel, jfaults), (ttel, tfaults)):
        tel.reset()
        tel.enable()
        if chaos:
            faults.install(faults.parse(CHAOS_PLAN))
        try:
            if tel is jtel:
                state = JaxApiState(JaxEngine(model, dtype=jnp.float32, tp=tp), JaxTokenizer.from_file(tok),
                                    JaxSampler(vocab_size=SPEC["vocab_size"], temperature=0.0, topp=0.9, seed=1),
                                    types.SimpleNamespace(**{**ARGS, "spec_draft": spec_draft, **extra}))
                server, url = _serve(state, jax_handler)
            else:
                state = torch_state(files, tp=tp, spec_draft=spec_draft, **extra)
                server, url = _serve(state, tapi.make_handler)
            if tp > 1:
                convs.append(conversation(state))
            faults.clear()
            try:
                before = _scrape(url)
                if chaos:
                    _chaos_traffic(state, url)
                else:
                    _sequential_traffic(url)
                key = 'dllama_http_requests_total{route="/v1/chat/completions",status="200"}'
                for _ in range(500):  # the handler counts a request after its last byte
                    after = _scrape(url)
                    if after.get(key, 0.0) - before.get(key, 0.0) >= (3 if chaos else 5) and after.get(
                            "dllama_http_requests_in_flight", 0.0) == 0.0:
                        break
                    threading.Event().wait(0.01)
            finally:
                server.shutdown()
                server.server_close()
            deltas.append({k: after.get(k, 0.0) - before.get(k, 0.0) for k in series})
        finally:
            faults.clear()
            tel.disable()
            tel.reset()
    want, got = deltas
    assert got == want
    if tp > 1:
        assert convs[1] == convs[0] and convs[0][0][2]["completion_tokens"] == 8
    if chaos:
        assert got["dllama_rows_quarantined_total"] == 1 and got["dllama_preempted_requeued_total"] == 1
        assert got["dllama_preemptions_total"] == 1 and got["dllama_deadline_exceeded_total"] == 1
        return
    assert got['dllama_http_requests_total{route="/v1/chat/completions",status="200"}'] == 5
    assert got["dllama_prefix_cache_hits_total"] > 0 and got["dllama_host_sampler_fallback_total"] == 0
    assert got["dllama_tokens_generated_total"] >= 8 + 8 + 7 + 6 + 1
    assert (got["dllama_spec_draft_tokens_total"] > 0) == (spec_draft > 0)


def _settled_metrics(url, *expected, timeout_s=10.0):
    """The /metrics text once it has settled: a handler counts its request
    (and a GET its route) after the response's last byte reaches the
    client, so a scrape at once can miss the last requests. Re-scrapes
    until the in-flight gauge reads 0 (as ``loadgen.__main__.settled_scrape``
    waits) and every ``expected`` line is present, or the timeout passes;
    returns the last scrape, which the caller asserts on."""
    deadline = time.monotonic() + timeout_s
    while True:
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            text = r.read().decode()
        settled = "dllama_http_requests_in_flight 0" in text.splitlines() and all(e in text for e in expected)
        if settled or time.monotonic() >= deadline:
            return text
        time.sleep(0.01)


def test_probes_metrics_trace_and_drain(files):
    """/healthz, /readyz (503 once draining), /metrics, /debug/trace/<id>
    (JSON with the queue/placement/prefill/decode stages, and Chrome), and
    503 for a completion during the drain."""
    from distributed_llama_tpu_torch import telemetry as ttel

    ttel.reset()
    ttel.enable()
    try:
        state = torch_state(files, parallel=2)
        server, url = _serve(state, tapi.make_handler)
        try:
            for path in ("/healthz", "/readyz"):
                with urllib.request.urlopen(url + path, timeout=10) as r:
                    assert r.status == 200
            with urllib.request.urlopen(url + "/readyz", timeout=10) as r:
                ready = json.loads(r.read())
            assert ready["status"] == "ready" and ready["free_slots"] == 2 and ready["replicas"][0]["slots"] == 2
            body = {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 4, "stream": True}
            with _post(url, body) as r:
                rid = r.headers["X-Request-Id"]
                r.read()
            with urllib.request.urlopen(url + f"/debug/trace/{rid}", timeout=10) as r:
                tree = json.loads(r.read())
            assert tree["request_id"] == rid and tree["emitted"] == 4 and tree["ttft_s"] > 0
            assert {"queue", "placement", "prefill", "decode"} <= set(tree["stages"])
            spans = {s["name"] for s in tree["attempts"][0]["spans"]}
            assert {"queue_wait", "placement", "prefix_match", "prefill_chunk", "prefill", "batch_decode_chunk_row",
                    "sse_send", "decode_stream"} <= spans
            with urllib.request.urlopen(url + f"/debug/trace/{rid}?format=chrome", timeout=10) as r:
                assert json.loads(r.read())["traceEvents"][0]["name"] == "attempt0"
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(url + "/debug/trace/nope", timeout=10)
            assert e.value.code == 404 and json.loads(e.value.read())["tracing_enabled"]
            text = _settled_metrics(url, 'dllama_ttft_seconds_count{tenant="default"} 1',
                                    'dllama_http_requests_total{route="/debug/trace",status="200"} 2')
            assert 'dllama_ttft_seconds_count{tenant="default"} 1' in text
            assert 'dllama_http_requests_total{route="/debug/trace",status="200"} 2' in text
            assert 'dllama_kernel_path_total{kernel="paged_attention",path="plain"}' in text
            state.begin_drain()
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(url + "/readyz", timeout=10)
            assert e.value.code == 503 and json.loads(e.value.read())["draining"]
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url, body)
            assert e.value.code == 503 and e.value.headers["Retry-After"]
            with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
                assert r.status == 200  # draining is still alive
            text = _settled_metrics(url, "dllama_server_draining 1",
                                    'dllama_http_requests_total{route="/v1/chat/completions",status="503"} 1')
            assert "dllama_server_draining 1" in text
            assert 'dllama_http_requests_total{route="/v1/chat/completions",status="503"} 1' in text
        finally:
            server.shutdown()
            server.server_close()
    finally:
        ttel.disable()
        ttel.reset()


def test_sigterm_drain_waits_for_in_flight(files):
    """The SIGTERM handler flips readiness, lets the in-flight completion
    finish, then shuts the server down; off the main thread nothing is
    installed and the handler is returned for the caller to invoke."""
    import signal

    state = torch_state(files, parallel=1)
    server, url = _serve(state, tapi.make_handler)
    got = {}
    threading.Thread(target=lambda: got.setdefault("h", tapi.install_sigterm_drain(state, server, 30.0))).start()
    for _ in range(100):
        if "h" in got:
            break
        threading.Event().wait(0.01)
    assert signal.getsignal(signal.SIGTERM) is not got["h"]
    slot = state._acquire_slot([{"role": "user", "content": "x"}])  # an in-flight request
    got["h"](signal.SIGTERM, None)
    assert state.draining and not state.drain_wait(0.05)
    state._release_slot(slot)
    assert state.drain_wait(5.0)
    for _ in range(200):  # the drain thread shuts the listener down
        try:
            urllib.request.urlopen(url + "/healthz", timeout=0.2)
        except OSError:
            break
        threading.Event().wait(0.02)
    else:
        pytest.fail("the server kept serving after the drain")
    server.server_close()
