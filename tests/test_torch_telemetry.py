"""The port's telemetry held against the JAX package's.

The same counter, gauge and histogram operations applied to both packages'
registries give byte-identical Prometheus text; request-trace trees, their
Chrome exports and the ring tracer's Chrome export are equal under injected
timestamps; a RequestTraceStore with the same seed keeps the same requests.
Then the port alone: null instruments while disabled, the bind-once
contract, no registry mutation on a decode with telemetry off, the engine,
scheduler, sampler and kernel-path feeds with it on (held against the JAX
engine's counters on the same f32 model), the dump CLI and the CLI's
``--telemetry --trace-out``.
"""

import json

import numpy as np
import pytest
import torch

from distributed_llama_tpu import telemetry as jtel
from distributed_llama_tpu.telemetry import registry as jreg
from distributed_llama_tpu.telemetry import trace as jtrace
from distributed_llama_tpu.telemetry import tracer as jtracer
from distributed_llama_tpu.telemetry.spans import SPAN_NAMES as JAX_SPAN_NAMES

from distributed_llama_tpu_torch import telemetry as ttel
from distributed_llama_tpu_torch.engine import InferenceEngine
from distributed_llama_tpu_torch.engine.batch import BatchScheduler
from distributed_llama_tpu_torch.engine.prefix_cache import PrefixCache
from distributed_llama_tpu_torch.formats import synthetic
from distributed_llama_tpu_torch.telemetry import registry as treg
from distributed_llama_tpu_torch.telemetry import trace as ttrace
from distributed_llama_tpu_torch.telemetry import tracer as ttracer
from distributed_llama_tpu_torch.telemetry.spans import SPAN_NAMES
from distributed_llama_tpu_torch.tokenizer import Sampler


@pytest.fixture
def enabled():
    """The port's telemetry on with a clean registry and tracer; restored
    to off and clean afterwards, so counts cannot leak between tests."""
    ttel.reset()
    ttel.enable()
    yield
    ttel.disable()
    ttel.reset()


@pytest.fixture
def disabled():
    ttel.reset()
    ttel.disable()
    yield
    ttel.reset()


# ----------------------------------------------------------------------
# Registry exposition: byte-identical across packages
# ----------------------------------------------------------------------


def _apply_ops(reg, seed: int) -> None:
    """A seeded sequence of counter/gauge/histogram operations, labelled and
    not, with values whose formatting exercises integers, floats, +Inf and
    escaped label values."""
    rng = np.random.default_rng(seed)
    c = reg.counter("t_requests_total", "requests", labelnames=("route", "status"))
    plain = reg.counter("t_tokens_total", "tokens")
    g = reg.gauge("t_occupancy", "occupancy")
    h = reg.histogram("t_latency_seconds", "latency")
    hb = reg.histogram("t_tokens", "per hit", labelnames=("tenant",), buckets=(1.0, 4.0, 16.0))
    reg.counter("t_never_total", "registered, never incremented")
    routes = ["/v1/chat/completions", "/metrics", 'we"ird\\n']
    for _ in range(40):
        op = int(rng.integers(0, 6))
        if op == 0:
            c.labels(route=routes[int(rng.integers(0, 3))], status=str(int(rng.choice([200, 429, 503])))).inc()
        elif op == 1:
            plain.inc(float(rng.integers(1, 40)))
        elif op == 2:
            g.set(float(rng.random()))
        elif op == 3:
            g.inc(float(rng.integers(-3, 4)))
        elif op == 4:
            h.observe(float(10.0 ** rng.uniform(-6, 1.5)))
        else:
            hb.labels(tenant=str(rng.choice(["default", "gold"]))).observe(float(rng.integers(0, 40)))


@pytest.mark.parametrize("seed", range(4))
def test_registry_exposition_byte_identical(seed):
    jr, tr = jreg.MetricsRegistry(), treg.MetricsRegistry()
    _apply_ops(jr, seed)
    _apply_ops(tr, seed)
    assert tr.prometheus_text() == jr.prometheus_text()
    assert tr.snapshot() == jr.snapshot()
    assert tr.names() == jr.names()


def test_registry_errors_match():
    for reg in (jreg.MetricsRegistry(), treg.MetricsRegistry()):
        reg.counter("x_total", labelnames=("a",))
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x_total")
        with pytest.raises(ValueError, match="labels"):
            reg.counter("x_total", labelnames=("a",)).labels(b="1")
        with pytest.raises(ValueError, match="counters only go up"):
            reg.counter("y_total").inc(-1)
        reg.histogram("h", buckets=(1.0, 2.0))
        with pytest.raises(ValueError, match="buckets"):
            reg.histogram("h", buckets=(1.0, 3.0))


def test_default_buckets_and_span_names_match():
    assert treg.DEFAULT_LATENCY_BUCKETS == jreg.DEFAULT_LATENCY_BUCKETS
    assert SPAN_NAMES == JAX_SPAN_NAMES
    assert ttel.PrefixCacheInstruments.MATCHED_TOKEN_BUCKETS == jtel.PrefixCacheInstruments.MATCHED_TOKEN_BUCKETS


@pytest.mark.parametrize("bundle", ["EngineInstruments", "PrefixCacheInstruments", "SamplerInstruments",
                                    "ServerInstruments", "MeshInstruments", "CollectiveInstruments"])
def test_instrument_bundles_keep_the_jax_names(bundle):
    """Every instrument the port binds has the JAX package's name, help
    text, kind, labels and buckets (the port binds a subset)."""
    ttel.reset()
    jtel.reset()
    ttel.enable()
    jtel.enable()
    try:
        getattr(ttel, bundle)()
        getattr(jtel, bundle)()
        ours, theirs = ttel.REGISTRY.snapshot(), jtel.REGISTRY.snapshot()
        assert ours and set(ours) <= set(theirs)
        for name, entry in ours.items():
            assert (entry["type"], entry["help"]) == (theirs[name]["type"], theirs[name]["help"]), name
            a, b = ttel.REGISTRY.get(name), jtel.REGISTRY.get(name)
            assert a.labelnames == b.labelnames, name
            assert getattr(a, "buckets", None) == getattr(b, "buckets", None), name
    finally:
        ttel.disable()
        jtel.disable()
        ttel.reset()
        jtel.reset()


# ----------------------------------------------------------------------
# Traces under injected timestamps
# ----------------------------------------------------------------------


class FakeClock:
    """time.perf_counter stand-in: each read advances by a fixed step."""

    def __init__(self, step: float = 0.001):
        self.t, self.step = 100.0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def _record_request(mod):
    ctx = mod.TraceContext("req-1", "default")
    ctx.begin_attempt()
    with mod.span(ctx, "queue_wait"):
        pass
    ctx.add_stage("queue", 0.25)
    ctx.add_span("prefix_match", 100.5, 0.002, matched_tokens=64, pages=1)
    with ctx.span("prefill", tokens=70, start_pos=0):
        pass
    ctx.add_stage("prefill", 0.5)
    for _ in range(3):
        ctx.mark_token()
    ctx.note(finish="length")
    ctx.begin_attempt(replayed=True)
    ctx.set_replica(0)
    ctx.add_stage("decode", 0.125)
    ctx.add_span("decode_stream", 100.9, 0.01, emitted=3)
    ctx.finish()
    return ctx


def test_trace_tree_and_chrome_equal(monkeypatch):
    monkeypatch.setattr("time.perf_counter", FakeClock())
    want = _record_request(jtrace)
    monkeypatch.setattr("time.perf_counter", FakeClock())
    got = _record_request(ttrace)
    assert got.tree() == want.tree()
    assert got.chrome_trace() == want.chrome_trace()
    assert got.ttft_s == want.ttft_s and got.tpot_s == want.tpot_s
    assert [n["replayed"] for n in got.tree()["attempts"]] == [False, True]


def test_span_tracer_chrome_export_equal(monkeypatch, tmp_path):
    def record(mod):
        t = mod.SpanTracer(capacity=4)
        with t.span("prefill", tokens=8):
            with t.span("device_sample", pos=7):
                pass
        for i in range(4):  # the ring drops the oldest
            with t.span("decode_chunk_fetch", tokens=i):
                pass
        return t

    monkeypatch.setattr("time.perf_counter", FakeClock())
    want = record(jtracer)
    monkeypatch.setattr("time.perf_counter", FakeClock())
    got = record(ttracer)
    assert got.chrome_trace() == want.chrome_trace()
    assert len(got.events()) == 4
    path = got.export_chrome_trace(str(tmp_path / "t.json"))
    assert json.loads(open(path).read()) == want.chrome_trace()


@pytest.mark.parametrize("sample_rate,slow", [(0.5, 0.0), (0.3, 0.05), (0.0, 0.02)])
def test_trace_store_keeps_the_same_requests(monkeypatch, sample_rate, slow):
    """Seeded retention: the same draws keep the same request ids in both
    packages, slow-TTFT requests always kept."""
    def run(mod):
        monkeypatch.setattr("time.perf_counter", FakeClock(0.004))
        store = mod.RequestTraceStore(capacity=8, sample_rate=sample_rate, slow_ttft_s=slow)
        kept = []
        for i in range(20):
            ctx = store.begin(f"r{i}", "default")
            for _ in range(i % 4):
                ctx.mark_token()
            if store.finish(ctx):
                kept.append(ctx.request_id)
        retained = [rid for rid in kept if store.get(rid) is not None]
        return kept, retained, store.stats()

    assert run(ttrace) == run(jtrace)


# ----------------------------------------------------------------------
# Disabled: null instruments, bind-once, no registry mutation
# ----------------------------------------------------------------------


def test_instruments_are_shared_noops(disabled):
    assert ttel.counter("x_total") is ttel.NULL_COUNTER
    assert ttel.gauge("x") is ttel.NULL_GAUGE
    assert ttel.histogram("x_seconds") is ttel.NULL_HISTOGRAM
    assert ttel.counter("x_total", labelnames=("a",)).labels(a="1") is ttel.NULL_COUNTER
    with ttel.span_factory()("prefill", tokens=1):
        pass
    ttel.note_kernel_path("q40_matmul", "plain")
    assert ttel.REGISTRY.names() == [] and ttel.TRACER.events() == []


def test_components_built_before_enable_stay_null(disabled):
    """The bind-once contract: enabling after construction changes nothing
    for components already built."""
    sampler = Sampler(vocab_size=8, temperature=0.0)
    cache = PrefixCache(4, 2)
    tel = ttel.EngineInstruments()
    ttel.enable()
    try:
        assert sampler._tel.fallback is ttel.NULL_COUNTER
        assert cache.tel.hits is ttel.NULL_COUNTER and cache.tel.pages is ttel.NULL_GAUGE
        assert tel.tokens_generated is ttel.NULL_COUNTER and not tel.enabled
        sampler.sample(np.arange(8, dtype=np.float32), pos=0)
        cache.match([1, 2, 3, 4, 5])
        assert ttel.REGISTRY.names() == []
        # a component built after enable() binds real instruments
        assert Sampler(vocab_size=8)._tel.fallback is not ttel.NULL_COUNTER
    finally:
        ttel.disable()


@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    d = tmp_path_factory.mktemp("tel")
    spec = synthetic.tiny_spec(dim=64, hidden_dim=128, vocab_size=128, seq_len=64)
    return synthetic.write_synthetic_model(str(d / "m.m"), spec, seed=3)


def _decode_everything(engine, sched):
    """The port's decode surfaces: prefill, decode_step, decode_chunk,
    generate_chunks, a fused-first stream_decode, a speculative one, and
    a batched row through the scheduler."""
    engine.prefill([1, 2, 3])
    engine.decode_step(4)
    engine.decode_chunk(5, 4, 0.0, 0.9)
    list(engine.generate_chunks(6, chunk=4, limit=engine.pos + 8))
    engine.reset()
    first = engine.prefill_device([1, 2, 3, 4], 0.0, 0.9, seed=0)
    engine.stream_decode(first, lambda p, t: True, 0.0, 0.9, chunk=4, limit=16, first_prev=4)
    engine.reset()
    first = engine.prefill_device([1, 2, 3, 1, 2, 3], 0.0, 0.9, seed=0)
    engine.stream_decode(first, lambda p, t: True, 0.0, 0.9, limit=14, first_prev=3, spec_draft=2,
                         prompt_tokens=[1, 2, 3, 1, 2, 3])
    row = sched.new_stream()
    first = row.prefill_device(list(range(1, 20)), 0.0, 0.9, seed=0)
    row.stream_decode(first, lambda p, t: True, 0.0, 0.9, limit=row.pos + 6, first_prev=19)


def test_telemetry_off_no_registry_mutation_on_decode(disabled, tiny_model):
    engine = InferenceEngine(tiny_model, dtype=torch.float32, device="cpu")
    sched = BatchScheduler(engine, n_rows=2, chunk=4, prefix_cache=True, page_size=8)
    _decode_everything(engine, sched)
    assert ttel.REGISTRY.names() == []
    assert ttel.TRACER.events() == []
    assert not ttel._kernel_paths


def test_enabled_engine_feeds_registry_like_jax(enabled, tiny_model):
    """The same calls on the JAX engine and the port's engine (f32 weights)
    count the same prompt, generated and device-sampled tokens."""
    import jax.numpy as jnp

    from distributed_llama_tpu.engine import InferenceEngine as JaxEngine

    def calls(engine):
        engine.prefill([1, 2, 3])
        engine.decode_step(4)
        engine.decode_chunk(5, 4, 0.0, 0.9)
        list(engine.generate_chunks(6, chunk=4, limit=engine.pos + 8))
        engine.reset()
        first = engine.prefill_device([1, 2, 3, 4], 0.0, 0.9, seed=0)
        engine.stream_decode(first, lambda p, t: True, 0.0, 0.9, chunk=4, limit=16, first_prev=4)
        engine.reset()
        first = engine.prefill_device([1, 2, 3, 1, 2, 3], 0.0, 0.9, seed=0)
        engine.stream_decode(first, lambda p, t: True, 0.0, 0.9, limit=14, first_prev=3, spec_draft=2,
                             prompt_tokens=[1, 2, 3, 1, 2, 3])

    names = ("dllama_prompt_tokens_total", "dllama_tokens_generated_total", "dllama_device_sampled_tokens_total",
             "dllama_spec_draft_tokens_total", "dllama_spec_accepted_tokens_total")
    jtel.reset()
    jtel.enable()
    try:
        calls(JaxEngine(tiny_model, dtype=jnp.float32))
        want = {n: jtel.REGISTRY.get(n).value for n in names}
        want["prefill_count"] = jtel.REGISTRY.get("dllama_prefill_latency_seconds").count
    finally:
        jtel.disable()
        jtel.reset()
    engine = InferenceEngine(tiny_model, dtype=torch.float32, device="cpu")
    calls(engine)
    reg = ttel.REGISTRY
    got = {n: reg.get(n).value for n in names}
    got["prefill_count"] = reg.get("dllama_prefill_latency_seconds").count
    assert got == want
    assert got["dllama_tokens_generated_total"] > 0 and got["dllama_spec_draft_tokens_total"] > 0
    assert reg.get("dllama_engine_streams").value == 1
    assert reg.get("dllama_kv_cache_occupancy").value == pytest.approx(engine.pos / engine.cfg.seq_len)
    spans = {e.name for e in ttel.TRACER.events()}
    assert {"forward", "prefill", "prefill_dispatch", "device_sample", "first_token_fetch",
            "decode_chunk_dispatch", "decode_chunk_fetch", "spec_verify"} <= spans
    assert spans <= set(SPAN_NAMES)


def test_scheduler_and_prefix_cache_feed_registry(enabled, tiny_model):
    engine = InferenceEngine(tiny_model, dtype=torch.float32, device="cpu")
    sched = BatchScheduler(engine, n_rows=2, chunk=4, prefix_cache=True, page_size=8)
    row = sched.new_stream()
    prompt = list(range(1, 20))
    for _ in range(2):  # a miss, then a hit on the published pages
        row.reset()
        first = row.prefill_device(prompt, 0.0, 0.9, seed=0)
        got = []
        row.stream_decode(first, lambda p, t: got.append(t) or True, 0.0, 0.9, limit=row.pos + 6, first_prev=19)
    reg = ttel.REGISTRY
    assert reg.get("dllama_prefix_cache_misses_total").value == 1
    assert reg.get("dllama_prefix_cache_hits_total").value == 1
    assert reg.get("dllama_prefix_cache_matched_tokens").sum == 16
    assert reg.get("dllama_prefix_cache_pages").value == sched._prefix.pages_in_use() == 2
    assert reg.get("dllama_prefix_cache_bytes").value == 2 * sched._prefix.page_bytes > 0
    assert reg.get("dllama_prefix_cache_copy_bytes_saved_total").value == 2 * sched._prefix.page_bytes
    # the row reads its matched pages until it resets
    assert reg.get("dllama_prefix_cache_pinned_pages").value == 2
    row.reset()
    assert reg.get("dllama_prefix_cache_pinned_pages").value == 0
    # per request: the fused first token, then two 4-token chunks
    assert reg.get("dllama_tokens_generated_total").value == 2 * (1 + 2 * 4)
    assert sched.tokens_delivered == 2 * 2 * 4  # the scheduler's own tally, first tokens aside
    assert reg.get("dllama_batch_occupancy").value == 1.0  # row 0 of a one-row bucket
    spans = {e.name for e in ttel.TRACER.events()}
    assert {"prefill_dispatch", "batch_decode_chunk", "batch_decode_fetch", "prefix_publish"} <= spans


def test_sampler_counters_match_jax():
    from distributed_llama_tpu.tokenizer import Sampler as JaxSampler

    logits = np.linspace(0, 1, 16).astype(np.float32)

    def run(tel, cls, **kw):
        tel.reset()
        tel.enable()
        try:
            for t, topp, topk in ((0.0, 0.9, 0), (0.7, 0.9, 0), (0.0, 0.9, 0), (0.7, 1.0, 0), (0.7, 1.0, 4)):
                cls(vocab_size=16, temperature=t, topp=topp, topk=topk, seed=1, **kw).sample(logits, pos=3)
            return tel.REGISTRY.snapshot()
        finally:
            tel.disable()
            tel.reset()

    got, want = run(ttel, Sampler), run(jtel, JaxSampler, counter=True)
    assert got == want
    assert got["dllama_host_sampler_fallback_total"]["series"][0]["value"] == 5
    methods = {s["labels"]["method"] for s in got["dllama_sampled_tokens_total"]["series"]}
    assert methods == {"greedy", "topp", "multinomial", "topk"}


def test_kernel_paths_on_the_cpu(enabled, tiny_model):
    """On the CPU every wrapper runs its plain version; the batched steps of
    a cache with S <= 512 take the einsum branch; the one-rank all-reduce
    sums by psum."""
    from distributed_llama_tpu_torch.ops import collectives, q40

    engine = InferenceEngine(tiny_model, dtype="q40", device="cpu")
    engine.prefill([1, 2, 3])
    sched = BatchScheduler(engine, n_rows=2, chunk=2, prefix_cache=False)
    row = sched.new_stream()
    first = row.prefill_device([1, 2, 3], 0.0, 0.9, seed=0)
    row.stream_decode(first, lambda p, t: True, 0.0, 0.9, limit=row.pos + 3, first_prev=3)
    qm = q40.quantize_q40_tpu(np.random.default_rng(0).standard_normal((512, 128)).astype(np.float32))
    q40.q40_matmul(torch.ones(2, 512), qm, "int8")
    q40.q40_matmul(torch.ones(2, 512), qm, "f32")
    collectives.all_reduce([torch.ones(4), torch.ones(4)], "psum")
    collectives.all_reduce([torch.ones(4), torch.ones(4)], "ring")
    collectives.all_reduce([torch.ones(4), torch.ones(4)], "ring_xla")
    series = {tuple(s["labels"].values()): s["value"]
              for s in ttel.REGISTRY.snapshot()["dllama_kernel_path_total"]["series"]}
    assert series[("q40_matmul", "plain")] >= 3  # the tiny model's matmuls take the f32 fallback
    assert series[("paged_attention", "einsum")] == 2 * sched.decode_forwards  # two layers a step
    assert series[("all_reduce", "psum")] == 1
    assert series[("all_reduce", "plain")] == 2
    assert {k for k, _ in series} == {"q40_matmul", "paged_attention", "all_reduce"}


def test_paged_attention_plain_path_counted(enabled):
    from distributed_llama_tpu_torch.ops import attention

    rng = np.random.default_rng(0)
    B, K, M, hd, S = 2, 2, 2, 16, 1024
    qg = torch.from_numpy(rng.standard_normal((B, K, M, hd), np.float32))
    keys = torch.from_numpy(rng.standard_normal((B, S, K, hd), np.float32))
    attention.batched_decode_attention(qg, keys, keys.clone(), torch.tensor([5, 700]), 512)
    series = ttel.REGISTRY.snapshot()["dllama_kernel_path_total"]["series"]
    assert series == [{"labels": {"kernel": "paged_attention", "path": "plain"}, "value": 1.0}]


def test_dump_cli_local(enabled, capsys, tmp_path):
    from distributed_llama_tpu_torch.telemetry import dump

    ttel.counter("dllama_tokens_generated_total", "tokens").inc(3)
    with ttel.trace_span("prefill", tokens=3):
        pass
    assert dump.main([]) == 0
    assert "dllama_tokens_generated_total 3" in capsys.readouterr().out
    path = tmp_path / "trace.json"
    assert dump.main(["--format", "json", "--trace", str(path)]) == 0
    snap = json.loads(capsys.readouterr().out)
    assert snap["dllama_tokens_generated_total"]["series"][0]["value"] == 3
    assert json.loads(path.read_text())["traceEvents"][0]["name"] == "prefill"


def test_cli_telemetry_writes_trace(tmp_path):
    from distributed_llama_tpu_torch.apps import cli
    from distributed_llama_tpu_torch.formats.tokenizer_file import write_tokenizer_file

    spec = synthetic.tiny_spec(dim=64, hidden_dim=128, vocab_size=512, seq_len=32)
    model = synthetic.write_synthetic_model(str(tmp_path / "m.m"), spec)
    with open(tmp_path / "t.t", "wb") as f:
        write_tokenizer_file(f, synthetic.synthetic_tokenizer_data(vocab_size=512))
    out = tmp_path / "trace.json"
    ttel.reset()
    try:
        cli.main(["generate", "--model", model, "--tokenizer", str(tmp_path / "t.t"), "--prompt", "hi",
                  "--device", "cpu", "--steps", "10", "--temperature", "0", "--decode-chunk", "4", "--telemetry",
                  "--trace-out", str(out)])
        names = {e["name"] for e in json.loads(out.read_text())["traceEvents"]}
        assert {"prefill_dispatch", "first_token_fetch", "decode_chunk_dispatch", "decode_chunk_fetch"} <= names
        assert ttel.REGISTRY.get("dllama_tokens_generated_total").value > 0
    finally:
        ttel.disable()
        ttel.reset()
