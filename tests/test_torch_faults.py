"""The port's fault containment held against the JAX package's.

* Fault plans: for the same spec and seed, ``FaultPlan.fire``/``fires``
  make the same decision on every hit (hypothesis over specs with
  ``after``, ``count``, ``p`` and ``row``), and ``parse`` rejects the same
  garbage. Exact.
* Backoff: ``BackoffPolicy.delay_s`` and ``retry_call``'s sleep schedule
  equal the JAX package's for the same seeds. Exact.
* The scheduler under faults: one synthetic f32 model (seq_len 1024, the
  paged prefix cache on, 4 rows) loaded by both packages, the same plan
  installed in both, four concurrent requests. Both schedulers deliver the
  same token streams to the survivors (which equal the port's fault-free
  streams), retire the same rows with the same error classes, and move
  their retry, quarantine, watchdog and preemption counters alike, at
  ``batch.row``, ``batch.fetch`` (raise and hang), ``batch.dispatch``,
  ``engine.paged_attn``, ``engine.fused_step``, ``engine.spec_verify``
  (``spec_draft`` 2) and ``engine.preempt``. Token ids and counters exact.
* Integrity: ``params_checksum`` of the port's params equals the JAX
  package's over the same ``.m`` file (q40 and bf16); ``corrupt_params``
  picks the same leaf and writes the same values; ``fold_run_fingerprint``
  is equal. Exact.
"""

import random
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from distributed_llama_tpu import retry as jretry
from distributed_llama_tpu import telemetry as jtel
from distributed_llama_tpu.engine import InferenceEngine as JaxEngine
from distributed_llama_tpu.engine import faults as jfaults
from distributed_llama_tpu.engine import integrity as jintegrity
from distributed_llama_tpu.engine.batch import BatchScheduler as JaxScheduler

from distributed_llama_tpu_torch import retry as tretry
from distributed_llama_tpu_torch import telemetry as ttel
from distributed_llama_tpu_torch.engine import InferenceEngine as TorchEngine
from distributed_llama_tpu_torch.engine import faults as tfaults
from distributed_llama_tpu_torch.engine import integrity as tintegrity
from distributed_llama_tpu_torch.engine.batch import BatchScheduler
from distributed_llama_tpu_torch.formats import synthetic as tsyn
from distributed_llama_tpu_torch.loadgen.report import parse_prometheus

SPEC = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512, seq_len=1024)
_RNG = np.random.RandomState(3)
SYSTEM = [int(t) for t in _RNG.randint(3, 500, 64)]  # one shared page
PROMPTS = [SYSTEM + [int(t) for t in _RNG.randint(3, 500, n)] for n in (6, 11, 3, 9)]
SAMPLING = [(0.0, 7), (0.8, 3), (0.0, 11), (0.8, 5)]  # (temperature, seed) per row
SCHED = dict(n_rows=4, chunk=4, prefix_cache=True, page_size=64, prefill_chunk=32, retry_backoff_s=0.001)
N = 12  # decoded tokens per request
COUNTERS = ("dllama_batch_retries_total", "dllama_rows_quarantined_total", "dllama_watchdog_stalls_total",
            "dllama_preemptions_total")


@pytest.fixture(autouse=True)
def _no_plan():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


# ----------------------------------------------------------------------
# Fault plans and backoff
# ----------------------------------------------------------------------

SITES = ("batch.row", "batch.fetch", "engine.paged_attn")
_rule = st.fixed_dictionaries({
    "site": st.sampled_from(SITES), "kind": st.sampled_from(["raise", "nan"]),
    "after": st.integers(0, 4), "count": st.sampled_from([-1, 0, 1, 2, 3]),
    "p": st.sampled_from([1.0, 0.5, 0.25]), "row": st.sampled_from([None, 0, 1, 2]),
})
_hit = st.tuples(st.sampled_from(SITES), st.sampled_from(["fire", "fires_row", "fires_rows"]),
                 st.integers(0, 3), st.lists(st.integers(0, 3), max_size=3))


def _spec(rules) -> str:
    return ";".join(f"{r['site']}:kind={r['kind']},after={r['after']},count={r['count']},p={r['p']}"
                    + ("" if r["row"] is None else f",row={r['row']}") for r in rules)


def _decide(mod, plan, hit):
    site, how, row, rows = hit
    try:
        if how == "fire":
            rule = plan.fire(site, row=row)
        elif how == "fires_row":
            rule = plan.fires(site, row=row)
        else:
            rule = plan.fires(site, rows=rows)
    except mod.InjectedFault:
        return "raised"
    return None if rule is None else plan.rules.index(rule)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(rules=st.lists(_rule, min_size=1, max_size=3), hits=st.lists(_hit, max_size=40), seed=st.integers(0, 99))
def test_fault_plans_decide_like_jax(rules, hits, seed):
    """The same spec and seed: the same decision (the rule, a raise, or
    nothing) on every hit, and the same injection count, also after a
    reset replays the plan."""
    spec = _spec(rules)
    jplan, tplan = jfaults.parse(spec, seed=seed), tfaults.parse(spec, seed=seed)
    for _ in range(2):
        assert [_decide(tfaults, tplan, h) for h in hits] == [_decide(jfaults, jplan, h) for h in hits]
        assert tplan.injected_total == jplan.injected_total
        jplan.reset()
        tplan.reset()


@pytest.mark.parametrize("bad", ["", "site:kind=explode", "site:bogus_field=1", ":kind=raise", "x:after=one",
                                 '[{"site": "x", "kind": "melt"}]', " ; "])
def test_parse_rejects_the_same_garbage(bad):
    with pytest.raises(ValueError):
        jfaults.parse(bad)
    with pytest.raises(ValueError):
        tfaults.parse(bad)


def test_parse_fields_kinds_and_sites_equal():
    spec = "batch.fetch:kind=hang,after=2,count=3,delay_ms=5.5;engine.sdc:kind=corrupt,row=0,message=logits,p=0.5"
    assert [vars(r) for r in tfaults.parse(spec, seed=4).rules] == [vars(r) for r in jfaults.parse(spec).rules]
    assert tfaults.SITES == jfaults.SITES and tfaults.KINDS == jfaults.KINDS
    assert tfaults.HANG_DEFAULT_MS == jfaults.HANG_DEFAULT_MS
    plan = tfaults.FaultPlan([tfaults.FaultRule("d", kind="disconnect"), tfaults.FaultRule("r")])
    with pytest.raises(BrokenPipeError):
        plan.fire("d")
    with pytest.raises(tfaults.InjectedFault):
        plan.fire("r")
    assert tfaults.active_plan() is tfaults.NULL_PLAN and tfaults.NULL_PLAN.fire("r") is None
    assert issubclass(tfaults.NonFiniteLogits, tfaults.RowQuarantined)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_backoff_delays_and_sleep_schedule_equal(seed):
    kw = dict(attempts=6, base_s=0.05, multiplier=3.0, max_s=1.2, jitter_s=0.4)
    jp, tp = jretry.BackoffPolicy(**kw), tretry.BackoffPolicy(**kw)
    jr, tr = random.Random(seed), random.Random(seed)
    assert [tp.delay_s(a, tr) for a in range(12)] == [jp.delay_s(a, jr) for a in range(12)]
    big = dict(attempts=-1, base_s=0.5, max_s=30.0)  # an UNBOUNDED loop's huge attempt saturates
    assert tretry.BackoffPolicy(**big).delay_s(5000) == jretry.BackoffPolicy(**big).delay_s(5000) == 30.0

    def schedule(mod, policy):
        slept, calls, retried = [], [0], []

        def fn():
            calls[0] += 1
            raise ValueError(calls[0])

        with pytest.raises(ValueError) as e:
            mod.retry_call(fn, policy, sleep=slept.append, rng=random.Random(seed),
                           on_retry=lambda a, exc: retried.append((a, str(exc))))
        return slept, calls[0], retried, str(e.value)

    assert schedule(tretry, tp) == schedule(jretry, jp)
    for bad in (dict(attempts=0), dict(attempts=-2), dict(attempts=1, base_s=-1.0), dict(attempts=2, multiplier=0.5)):
        with pytest.raises(ValueError):
            jretry.BackoffPolicy(**bad)
        with pytest.raises(ValueError):
            tretry.BackoffPolicy(**bad)
    with pytest.raises(KeyboardInterrupt):  # only retry_on is retried
        tretry.retry_call(lambda: (_ for _ in ()).throw(KeyboardInterrupt()), tp, sleep=lambda d: None)


# ----------------------------------------------------------------------
# The scheduler under faults
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Both packages' engines over one model, built with telemetry on (the
    engines bind their instruments once), and the port's fault-free
    streams."""
    path = str(tmp_path_factory.mktemp("torch_faults") / "model.m")
    tsyn.write_synthetic_model(path, tsyn.tiny_spec(**SPEC), seed=1)
    for tel in (jtel, ttel):
        tel.reset()
        tel.enable()
    try:
        jeng = JaxEngine(path, dtype=jnp.float32)
        teng = TorchEngine(path, dtype=torch.float32, device="cpu")
        clean, errs = run_rows(BatchScheduler(teng, **SCHED))
        assert errs == [None] * 4
        clean_spec, errs = run_rows(BatchScheduler(teng, **SCHED, spec_draft=2))
        assert errs == [None] * 4
        yield jeng, teng, {0: clean, 2: clean_spec}, path
    finally:
        for tel in (jtel, ttel):
            tel.disable()
            tel.reset()


def run_rows(sched, n=N, mid=None, pre=None):
    """Four concurrent requests, one per row (the serving pattern); returns
    (tokens per row, error per row). ``pre(streams)`` runs before they
    start, ``mid(row, n_got)`` after each delivered token."""
    streams = list(sched._streams) or [sched.new_stream() for _ in range(4)]
    if pre is not None:
        pre(streams)
    outs, errs = [None] * 4, [None] * 4

    def one(i):
        s, prompt = streams[i], PROMPTS[i]
        temp, seed = SAMPLING[i]
        got = []
        try:
            first = s.prefill_device(prompt, temp, 0.9, seed)

            def on_token(prev, tok):
                got.append(tok)
                if mid is not None:
                    mid(i, len(got))
                return len(got) < n

            s.stream_decode(first, on_token, temp, 0.9, seed=seed, limit=s.pos + n, first_prev=prompt[-1])
            outs[i] = got
        except Exception as e:
            outs[i], errs[i] = got, e

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a request thread hung"
    sched.check_prefix()
    return outs, errs


def _counters(tel) -> dict:
    m = parse_prometheus(tel.prometheus_text())
    return {c: sum(v for k, v in m.items() if k == c or k.startswith(c + "{")) for c in COUNTERS}


def _under_plan(spec, jeng, teng, spec_draft=0, pre=None, mid=None, **kw):
    """Both schedulers under the same plan (None: no plan): (outs, error
    classes, counter deltas, scheduler) per package, JAX's first."""
    res = []
    for tel, faults, make, eng in ((jtel, jfaults, JaxScheduler, jeng), (ttel, tfaults, BatchScheduler, teng)):
        if spec is not None:
            faults.install(faults.parse(spec))
        sched = make(eng, **{**SCHED, **kw}, spec_draft=spec_draft)
        faults.clear()
        try:
            before = _counters(tel)
            outs, errs = run_rows(sched, pre=pre, mid=None if mid is None else (lambda i, n: mid(sched, i, n)))
            after = _counters(tel)
        finally:
            sched.close()
        res.append((outs, [None if e is None else type(e).__name__ for e in errs],
                    {k: after[k] - before[k] for k in COUNTERS}, sched))
    return res


@pytest.mark.parametrize("spec,victims,moved", [
    ("batch.row:kind=nan,row=2,count=1", [2], {"dllama_rows_quarantined_total": 1}),
    ("batch.fetch:kind=raise,after=1,count=1", [], {"dllama_batch_retries_total": 1}),
    ("batch.dispatch:kind=raise,after=2,count=1", [], {"dllama_batch_retries_total": 1}),
    ("engine.paged_attn:kind=raise,row=1,count=1", [1], {"dllama_rows_quarantined_total": 1}),
    ("engine.fused_step:kind=raise,row=3,after=2,count=1", [3], {"dllama_rows_quarantined_total": 1}),
], ids=["batch.row", "batch.fetch", "batch.dispatch", "engine.paged_attn", "engine.fused_step"])
def test_scheduler_under_faults_matches_jax(monkeypatch, engines, spec, victims, moved):
    monkeypatch.setenv("DLT_FUSED_PAGED", "0")
    jeng, teng, clean, _ = engines
    (jouts, jerrs, jdelta, _), (touts, terrs, tdelta, tsched) = _under_plan(spec, jeng, teng)
    assert terrs == jerrs
    assert [i for i, e in enumerate(terrs) if e is not None] == victims
    assert all(terrs[i] == "RowQuarantined" for i in victims)
    for i in range(4):
        if i not in victims:
            assert touts[i] == jouts[i] == clean[0][i], f"survivor row {i}"
    assert tdelta == jdelta
    assert all(tdelta[k] == moved.get(k, 0) for k in COUNTERS), tdelta
    assert all(not s._alias_chain for s in tsched._streams if s.row in victims)  # the victim's pins went


def test_dispatch_retries_exhausted_retire_rows_and_scheduler_serves_on(monkeypatch, engines):
    """count=3 outlasts one dispatch's three attempts: every row of that
    dispatch retires typed in both packages (which rows had joined by the
    first dispatch is timing: the JAX scheduler dispatches chunk 1 as its first
    row joins), two retries and one quarantine per retired row count in
    both, the other rows stream their fault-free streams, and the port's
    scheduler serves the next round."""
    monkeypatch.setenv("DLT_FUSED_PAGED", "0")
    jeng, teng, clean, _ = engines
    for outs, errs, delta, _ in _under_plan("batch.dispatch:kind=raise,count=3", jeng, teng):
        assert set(errs) <= {"RowQuarantined", None} and "RowQuarantined" in errs
        assert delta["dllama_batch_retries_total"] == 2
        assert delta["dllama_rows_quarantined_total"] == errs.count("RowQuarantined")
        for i, e in enumerate(errs):
            if e is None:
                assert outs[i] == clean[0][i]
    outs, errs = run_rows(BatchScheduler(teng, **SCHED))
    assert errs == [None] * 4 and outs == clean[0]


def test_launch_error_is_not_retried(engines, monkeypatch):
    """A launch that raises (a kernel that failed to launch, a CUDA error)
    is not retried: it retires the dispatch's rows typed, the error as
    their cause, and the retry counter stays still."""
    _, teng, _, _ = engines
    sched = BatchScheduler(teng, **SCHED)
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    from distributed_llama_tpu_torch.models import sampling

    monkeypatch.setattr(sampling, "decode_chunk_batched_paged", broken)
    before = _counters(ttel)
    outs, errs = run_rows(sched)
    delta = {k: _counters(ttel)[k] - before[k] for k in COUNTERS}
    assert all(isinstance(e, tfaults.RowQuarantined) for e in errs)
    assert all("illegal memory access" in str(e.__cause__) for e in errs)
    assert delta["dllama_batch_retries_total"] == 0 and delta["dllama_rows_quarantined_total"] == 4
    assert 1 <= len(calls) <= 4


def test_a_retired_row_is_not_dispatched_again(engines):
    """A row retired by a failed dispatch keeps its seat until its thread
    raises the error; meanwhile another row's dispatch must not serve it
    again (a second failed launch would count its quarantine twice: 5 or 6
    of 4 rows under load). Only rows without an error are dispatched, and a
    failed dispatch quarantines exactly those."""
    _, teng, _, _ = engines
    sched = BatchScheduler(teng, **SCHED)
    try:
        a, b = sched.new_stream(), sched.new_stream()
        a._joined = b._joined = True
        a._fetch_error = tfaults.RowQuarantined("retired by the first dispatch")
        with sched._cond:
            assert sched._dispatchable_locked() == [b]
            before = sched.quarantined_total

            def broken():
                raise RuntimeError("CUDA error: an illegal memory access was encountered")

            assert sched._run_dispatch_locked(sched._dispatchable_locked(), broken, "retired") is None
        assert sched.quarantined_total - before == 1
        assert "retired by the first dispatch" in str(a._fetch_error) and "retired" in str(b._fetch_error)
        a._joined = b._joined = False
    finally:
        sched.close()


def _barrier_at_first_token():
    """A ``mid`` hook that holds every row at its first token until all
    four rows have joined the batch."""
    barrier = threading.Barrier(4)

    def mid(sched, row, n_got):
        if n_got == 1:
            barrier.wait(timeout=60)

    return mid


def test_hung_fetch_trips_the_watchdog_like_jax(monkeypatch, engines):
    """A fetch that hangs 1.5 s against a 0.25 s stall timeout, all four
    rows joined: every row ends StallTimeout in both packages and the
    watchdog counts one stall, no quarantine."""
    monkeypatch.setenv("DLT_FUSED_PAGED", "0")
    jeng, teng, _, _ = engines
    (jouts, jerrs, jdelta, _), (touts, terrs, tdelta, tsched) = _under_plan(
        "batch.fetch:kind=hang,delay_ms=1500,count=1", jeng, teng, mid=_barrier_at_first_token(),
        stall_timeout_s=0.25)
    assert terrs == jerrs == ["StallTimeout"] * 4
    assert tdelta == jdelta and tdelta["dllama_watchdog_stalls_total"] == 1
    assert tdelta["dllama_rows_quarantined_total"] == 0
    assert tsched._pending is None and not tsched._fetching
    assert all(not s._alias_chain for s in tsched._streams)


def test_hung_fetch_holds_no_request_thread(engines):
    """In the port the hung wait runs on a helper thread: every row ends
    StallTimeout well before a 6 s hang ends (1 s timeout), the late
    completion delivers nothing, and the scheduler serves the next round
    (the timeout leaves room for a loaded CPU's fault-free fetches)."""
    _, teng, clean, _ = engines
    tfaults.install(tfaults.parse("batch.fetch:kind=hang,delay_ms=6000,count=1"))
    sched = BatchScheduler(teng, **SCHED, stall_timeout_s=1.0)
    tfaults.clear()
    mid = _barrier_at_first_token()
    try:
        t0 = time.monotonic()
        outs, errs = run_rows(sched, mid=lambda i, n: mid(sched, i, n))
        assert time.monotonic() - t0 < 4.5
        assert all(isinstance(e, tfaults.StallTimeout) for e in errs)
        for s in sched._streams:
            s.reset()
        outs, errs = run_rows(sched)
        assert errs == [None] * 4 and outs == clean[0]
    finally:
        sched.close()


def test_spec_verify_row_fault_matches_jax(monkeypatch, engines):
    """``engine.spec_verify`` with ``spec_draft`` 2: the targeted row alone
    retires in both packages; the survivors stream the fault-free spec
    streams."""
    monkeypatch.setenv("DLT_FUSED_PAGED", "0")
    jeng, teng, clean, _ = engines
    (jouts, jerrs, jdelta, _), (touts, terrs, tdelta, _) = _under_plan(
        "engine.spec_verify:kind=raise,row=0,after=1,count=1", jeng, teng, spec_draft=2)
    assert terrs == jerrs == ["RowQuarantined", None, None, None]
    for i in (1, 2, 3):
        assert touts[i] == jouts[i] == clean[2][i]
    assert tdelta == jdelta and tdelta["dllama_rows_quarantined_total"] == 1


@pytest.mark.parametrize("preempt_spec,want", [(None, "RowPreempted"),
                                               ("engine.preempt:kind=raise,count=1", "RowQuarantined")],
                         ids=["clean", "engine.preempt"])
def test_preempt_below_matches_jax(monkeypatch, engines, preempt_spec, want):
    """A priority-5 arrival evicts the lowest-priority row (row 0 at
    priority 0, rows 1-3 at 3) mid-decode: ``RowPreempted`` and one
    preemption counted, or with the ``engine.preempt`` raise a quarantine
    instead; the survivors' streams are untouched."""
    monkeypatch.setenv("DLT_FUSED_PAGED", "0")
    jeng, teng, clean, _ = engines

    def pre(streams):
        for s, prio in zip(streams, (0, 3, 3, 3)):
            s.priority = prio

    def mid(sched, row, n_got):
        if row == 0 and n_got == 3:  # the victim is mid-decode
            sched.preempt_below(5)

    (jouts, jerrs, jdelta, jsched), (touts, terrs, tdelta, tsched) = _under_plan(
        preempt_spec, jeng, teng, pre=pre, mid=mid)
    assert terrs == jerrs == [want, None, None, None]
    assert len(touts[0]) == len(jouts[0]) == 3
    for i in (1, 2, 3):
        assert touts[i] == jouts[i] == clean[0][i]
    assert tdelta == jdelta
    assert tdelta["dllama_preemptions_total"] == (1 if want == "RowPreempted" else 0)
    assert tdelta["dllama_rows_quarantined_total"] == (0 if want == "RowPreempted" else 1)
    assert tsched.preempted_total == jsched.preempted_total


def test_retract_preemption_and_join_keep_the_marker(engines):
    """A preemption that lands before the row joins survives the join (the
    first next_token raises it); one the request beat to its end is
    retracted, so it cannot requeue the row's next request."""
    _, teng, _, _ = engines
    sched = BatchScheduler(teng, **SCHED)
    s = sched.new_stream()
    s.priority = 0
    assert sched.preempt_below(1) and sched.preempted_total == 1
    sched._join(s, 5, 0.0, 0.9, 1, 0)
    with pytest.raises(tfaults.RowPreempted):
        sched.next_token(s)
    sched._leave(s)
    assert sched.preempt_below(1) and not sched.preempt_below(0)
    sched.retract_preemption(s)
    assert s._fetch_error is None


def test_deadline_between_chunks_and_prefill_pieces_matches_jax(monkeypatch, engines):
    """An expired deadline ends its row with DeadlineExceeded at its first
    chunk or prefill-piece boundary in both packages; the other rows
    stream on."""
    monkeypatch.setenv("DLT_FUSED_PAGED", "0")
    jeng, teng, clean, _ = engines

    def pre(streams):
        streams[3].deadline = time.monotonic() - 0.001

    (jouts, jerrs, _, _), (touts, terrs, _, tsched) = _under_plan(None, jeng, teng, pre=pre)
    assert terrs == jerrs == [None, None, None, "DeadlineExceeded"]
    for i in range(3):
        assert touts[i] == jouts[i] == clean[0][i]
    tsched._streams[3].reset()
    assert tsched._streams[3].deadline is None


def test_run_fingerprint_equal_and_sdc_corrupts(monkeypatch, engines):
    """The same greedy streams fold to the same run fingerprints in both
    packages; the ``engine.sdc`` site's ``message=logits`` shifts one
    chunk in-vocab without a quarantine."""
    monkeypatch.setenv("DLT_FUSED_PAGED", "0")
    jeng, teng, clean, _ = engines
    fps = []
    for make, eng in ((JaxScheduler, jeng), (BatchScheduler, teng)):
        sched = make(eng, **SCHED)
        outs, errs = run_rows(sched)
        assert errs == [None] * 4
        fps.append([s.run_fingerprint(N - 1) for s in sched._streams])
    assert fps[1] == fps[0]
    tfaults.install(tfaults.parse("engine.sdc:kind=corrupt,message=logits,after=1,count=1"))
    sched = BatchScheduler(teng, **SCHED)
    tfaults.clear()
    outs, errs = run_rows(sched)
    assert errs == [None] * 4 and outs != clean[0]
    assert all(0 <= t < SPEC["vocab_size"] for o in outs for t in o)


# ----------------------------------------------------------------------
# Integrity
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["q40", "bf16"])
def test_params_checksum_and_corruption_equal_jax(tmp_path, dtype):
    """The same `.m` file: the port's params checksum equals the JAX
    package's (every leaf word-summed, bf16 words zero-extended), the
    engine's cached checksum too, a single flipped bit moves it, and
    ``corrupt_params`` picks the same leaf and writes the same values."""
    path = str(tmp_path / "m.m")
    tsyn.write_synthetic_model(path, tsyn.tiny_spec(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                                                    vocab_size=512, seq_len=64), seed=2)
    jdt, tdt = ("q40", "q40") if dtype == "q40" else (jnp.bfloat16, torch.bfloat16)
    jeng = JaxEngine(path, dtype=jdt)
    teng = TorchEngine(path, dtype=tdt, device="cpu")
    want = jintegrity.params_checksum(jeng.params)
    assert tintegrity.params_checksum(teng.params) == want == teng.weights_checksum()
    leaf = teng.params["layers"][1]["rms_ffn"]
    bits = leaf.view(torch.int32)
    bits[5] ^= 1 << 3  # one mantissa bit
    assert tintegrity.params_checksum(teng.params) != want
    bits[5] ^= 1 << 3
    assert tintegrity.params_checksum(teng.params) == want
    for seed in (0, 3, 11):
        jnew, jdesc = jintegrity.corrupt_params(jeng.params, seed=seed)
        _, tdesc = tintegrity.corrupt_params(teng.params, seed=seed)
        assert tdesc == jdesc
        assert tintegrity.params_checksum(teng.params) == jintegrity.params_checksum(jnew)
        jeng.params = jnew
    assert teng.weights_checksum() == want  # the load-time record


def test_checksum_slices_equal_one_pass(monkeypatch):
    """A leaf summed in many slices equals the one-slice sum, for every
    word width (bf16 and int16 words zero-extended, uint8, f32)."""
    g = torch.Generator().manual_seed(0)
    leaves = {"a": torch.randn(1000, generator=g).to(torch.bfloat16), "b": torch.randint(0, 256, (777,), generator=g,
                                                                                             dtype=torch.uint8),
              "c": torch.randn(513, generator=g), "d": -torch.arange(300, dtype=torch.int16)}
    want = tintegrity.params_checksum(leaves)
    monkeypatch.setattr(tintegrity, "_SUM_SLICE", 64)
    assert tintegrity.params_checksum(leaves) == want
    sums = [int(tintegrity._leaf_word_sum(v)) for _, v in tintegrity._leaves(leaves)]
    ref = [int(np.sum(v.view(torch.int16).numpy().astype(np.uint16), dtype=np.uint64) % 2**32) if v.element_size() == 2
           else int(np.sum(v.view(torch.uint8).numpy() if v.element_size() == 1 else v.view(torch.int32).numpy()
                           .astype(np.uint32), dtype=np.uint64) % 2**32)
           for _, v in tintegrity._leaves(leaves)]
    assert sums == ref


@settings(max_examples=50, deadline=None, derandomize=True)
@given(run=st.integers(0, 2**32 - 1), fp=st.integers(0, 2**32 - 1))
def test_fold_run_fingerprint_equal(run, fp):
    assert tintegrity.fold_run_fingerprint(run, fp) == jintegrity.fold_run_fingerprint(run, fp)


@pytest.mark.parametrize("site", ["engine.forward", "engine.decode_dispatch", "engine.fetch", "engine.spec_verify"])
def test_single_stream_sites_raise_once_then_serve(engines, site):
    """The single-stream surface fires its sites where the JAX package's
    does: the first request through the site raises InjectedFault, the
    stream serves the next one; a fault plan binds at construction."""
    _, _, _, path = engines
    tfaults.install(tfaults.parse(f"{site}:kind=raise,count=1"))
    engine = TorchEngine(path, dtype=torch.float32, device="cpu")
    tfaults.clear()
    stream = engine.new_stream()
    spec = 2 if site == "engine.spec_verify" else 0

    def run():
        stream.reset()
        first = stream.prefill_device(PROMPTS[0], 0.0, 0.9, 7)
        got = []
        stream.stream_decode(first, lambda p, t: got.append(t) or len(got) < N, 0.0, 0.9, seed=7,
                             limit=stream.pos + N, first_prev=PROMPTS[0][-1], spec_draft=spec,
                             prompt_tokens=PROMPTS[0])
        return got

    with pytest.raises(tfaults.InjectedFault, match=site):
        run()
    assert len(run()) == N
    assert TorchEngine(path, dtype=torch.float32, device="cpu")._faults is tfaults.NULL_PLAN


def test_unclosed_scheduler_is_freed(engines):
    """The watchdog thread holds its scheduler weakly: a scheduler dropped
    without close() is freed, slab and pool with it, and the thread ends."""
    import gc
    import weakref

    _, teng, _, _ = engines
    sched = BatchScheduler(teng, **SCHED, stall_timeout_s=0.05)
    thread, ref = sched._watchdog, weakref.ref(sched)
    del sched
    gc.collect()
    assert ref() is None
    thread.join(timeout=5)
    assert not thread.is_alive()
