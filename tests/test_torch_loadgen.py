"""The port's load generator held against the JAX package's.

Schedules and their fingerprints are equal for the same (spec, seed) over
arrival kinds and seeds; the summary statistics, the Prometheus parser,
the metric deltas, the client/server skew, the whole report and the
isolation check are equal on the same inputs; the CLI's options whose
subsystem the port lacks raise ValueError; ``python -m distributed_llama_tpu_torch.loadgen --self-host
--device cpu --assert`` exits 0 (also with a fault plan and with
``--isolation``), and the port's self-host streams the JAX self-host's
completions for the same schedule.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from distributed_llama_tpu import stats as jstats
from distributed_llama_tpu.loadgen import report as jrep
from distributed_llama_tpu.loadgen import runner as jrun
from distributed_llama_tpu.loadgen import workload as jwl

from distributed_llama_tpu_torch import stats as tstats
from distributed_llama_tpu_torch.loadgen import __main__ as tmain
from distributed_llama_tpu_torch.loadgen import report as trep
from distributed_llama_tpu_torch.loadgen import runner as trun
from distributed_llama_tpu_torch.loadgen import workload as twl


def _workload(mod, **kw):
    tenants = kw.pop("tenants", None)
    if tenants is not None:
        kw["tenants"] = [mod.TenantLoad(**t) for t in tenants]
    return mod.Workload(**kw)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), arrival=st.sampled_from(["poisson", "burst", "uniform"]),
       n=st.integers(1, 40), rate=st.floats(0.1, 100.0), prefixes=st.integers(1, 6), temperature=st.sampled_from(
           [0.0, 0.8]), two_tenants=st.booleans())
def test_schedule_fingerprints_equal(seed, arrival, n, rate, prefixes, temperature, two_tenants):
    kw = dict(seed=seed, arrival=arrival, n_requests=n, rate_rps=rate, n_prefixes=prefixes, temperature=temperature,
              topk=3 if temperature else 0)
    if two_tenants:
        kw["tenants"] = [dict(name="gold", share=0.3, slo_ttft_ms=500.0), dict(name="free", share=0.7, max_tokens=4)]
    want = jwl.build_schedule(_workload(jwl, **dict(kw)))
    got = twl.build_schedule(_workload(twl, **dict(kw)))
    assert twl.schedule_fingerprint(got) == jwl.schedule_fingerprint(want)
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
    assert twl.scheduled_counts(got) == jwl.scheduled_counts(want)


def test_tenant_spec_parsing_equal():
    spec = "gold:share=0.3,priority=5,slo_ttft_ms=2000;free:share=0.7,max_tokens=4"
    assert [dataclasses.asdict(t) for t in twl.parse_tenant_loads(spec)] == [
        dataclasses.asdict(t) for t in jwl.parse_tenant_loads(spec)]
    for bad in ("a:share=1;a:share=2", "a:colour=3"):
        with pytest.raises(ValueError):
            twl.parse_tenant_loads(bad)


@pytest.mark.parametrize("seed", range(4))
def test_stats_equal(seed):
    xs = list(np.random.default_rng(seed).exponential(50.0, size=1 + 7 * seed))
    for q in (0.0, 25.0, 50.0, 90.0, 99.0, 100.0):
        assert tstats.percentile(xs, q) == jstats.percentile(xs, q)
    assert tstats.summarize(xs, unit="ms") == jstats.summarize(xs, unit="ms")
    assert tstats.median(xs) == jstats.median(xs)
    assert tstats.summarize([]) == jstats.summarize([]) == {"n": 0}
    with pytest.raises(ValueError):
        tstats.percentile([], 50)


PROM_BEFORE = """# HELP dllama_tokens_generated_total tokens
# TYPE dllama_tokens_generated_total counter
dllama_tokens_generated_total 10
dllama_http_requests_total{route="/v1/chat/completions",status="200"} 3
dllama_prefix_cache_hits_total 1
dllama_request_stage_seconds_sum{stage="queue",tenant="default"} 0.5
dllama_request_stage_seconds_sum{stage="decode",tenant="default"} 2
dllama_ttft_seconds_count{tenant="default"} 3
"""
PROM_AFTER = """dllama_tokens_generated_total 74
dllama_http_requests_total{route="/v1/chat/completions",status="200"} 11
dllama_http_requests_total{route="/v1/chat/completions",status="429"} 2
dllama_prefix_cache_hits_total 6
dllama_prefix_cache_misses_total 2
dllama_prefix_cache_matched_tokens_sum 384
dllama_request_stage_seconds_sum{stage="queue",tenant="default"} 0.75
dllama_request_stage_seconds_sum{stage="decode",tenant="default"} 5.25
dllama_request_stage_seconds_sum{stage="prefill",tenant="gold"} 1.5
dllama_ttft_seconds_count{tenant="default"} 11
dllama_host_sampler_fallback_total 0
garbage line without a number x
"""


def _results(mod, seed: int):
    """Seeded results over every outcome, with ttft/tpot/e2e and contents
    (body keys repeat; request 9's content differs from its key's others)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(16):
        outcome = str(rng.choice(mod.OUTCOMES, p=[0.6, 0.1, 0.05, 0.05, 0.1, 0.1]))
        done = outcome == "completed"
        out.append(mod.RequestResult(
            index=i, tenant=["default", "gold"][i % 2], at_s=i * 0.25, body_key=f"k{i % 5}", prefix_id=i % 3,
            outcome=outcome, status=200 if done else 429, ttft_ms=float(rng.uniform(5, 900)) if done else None,
            tpot_ms=float(rng.uniform(1, 90)) if done else None, e2e_ms=float(rng.uniform(900, 3000)),
            n_deltas=int(rng.integers(1, 9)) if done else 0, content=f"c{i % 5}" if i != 9 else "other",
            retry_after=1 if outcome == "rejected_429" else None, sched_lag_ms=float(rng.uniform(0, 2))))
    return out


def test_prometheus_parse_and_deltas_equal():
    for text in (PROM_BEFORE, PROM_AFTER):
        assert trep.parse_prometheus(text) == jrep.parse_prometheus(text)
    b, a = trep.parse_prometheus(PROM_BEFORE), trep.parse_prometheus(PROM_AFTER)
    assert trep.metric_deltas(b, a) == jrep.metric_deltas(b, a)
    assert trep.SERVER_COUNTERS == jrep.SERVER_COUNTERS
    assert trep.metric_deltas(b, a)["dllama_prefix_cache_hits_total"] == 5


@pytest.mark.parametrize("seed", range(3))
def test_report_equal(seed):
    b, a = jrep.parse_prometheus(PROM_BEFORE), jrep.parse_prometheus(PROM_AFTER)
    kw = dict(n_requests=16, tenants=[dict(name="default", slo_ttft_ms=400.0), dict(name="gold", slo_e2e_ms=2500.0)])
    reports = []
    for wl, rep in ((jwl, jrep), (twl, trep)):
        w = _workload(wl, **dict(kw))
        sched = wl.build_schedule(w)
        results = _results(jrun if rep is jrep else trun, seed)
        r = rep.build_report(w, sched, results, 7.5, wl.schedule_fingerprint(sched), True,
                             metrics_before=b, metrics_after=a)
        r["checks"]["goodput"] = rep.check_goodput(r, 0.5)
        r["checks"]["expected_deltas"] = rep.check_expected_deltas(r, ["dllama_tokens_generated_total:64",
                                                                       "dllama_nope_total", "bad:x"])
        r["checks"]["expected_zero"] = rep.check_expected_zero(r, ["dllama_host_sampler_fallback_total",
                                                                   "dllama_prefix_cache_hits_total"])
        r["failed"] = rep.failed_checks(r)
        reports.append(r)
    assert reports[1] == reports[0]
    assert trep.client_server_skew(_results(trun, seed), b, a) == jrep.client_server_skew(_results(jrun, seed), b, a)


def test_expected_zero_without_metrics_fails():
    r = {"server": None}
    assert trep.check_expected_zero(r, ["x"]) == jrep.check_expected_zero(r, ["x"])
    assert not trep.check_expected_zero(r, ["x"])["ok"]


# the options whose subsystem the port now has (fault plans, tenants with
# priority and deadline, preemption, the isolation proof, replicas, the
# flight-recorder gate, the canary, shadow votes, rollouts and pods): accepted
PORTED = (["--faults", "batch.fetch:kind=raise"], ["--server-tenants", "gold:weight=2"], ["--no-preempt"],
          ["--isolation", "gold"], ["--tenants", "gold:priority=5"], ["--tenants", "gold:deadline_ms=500"],
          ["--replicas", "2"], ["--expect-flight", "failover:1"], ["--canary-interval-s", "1"],
          ["--shadow-rate", "0.5"], ["--rollout-weights", "same"], ["--pod", "2x1"])


@pytest.mark.parametrize("argv", [
    ["--faults", "batch.fetch:kind=raise"], ["--replicas", "2"], ["--pod", "2x1"],
    ["--server-tenants", "gold:weight=2"], ["--no-preempt"], ["--isolation", "gold"],
    ["--canary-interval-s", "1"], ["--shadow-rate", "0.5"], ["--rollout-weights", "same"],
    ["--expect-flight", "failover:1"], ["--tenants", "gold:priority=5"], ["--tenants", "gold:deadline_ms=500"],
])
def test_unported_options_raise(argv):
    """Options whose subsystem is not ported raise ValueError naming their
    ROADMAP.md item; the ones now ported pass the check and parse."""
    if argv in PORTED:
        args = tmain.build_parser().parse_args(["--url", "http://127.0.0.1:9", *argv])
        tmain.check_ported(args)
        assert twl.build_schedule(tmain.make_workload(args))
        return
    with pytest.raises(ValueError, match="not ported yet: ROADMAP.md"):
        tmain.main(["--url", "http://127.0.0.1:9", *argv])


def test_sampled_share_is_pure_and_mixes():
    args = tmain.build_parser().parse_args(["--url", "http://x", "--requests", "24", "--temperature", "0.8",
                                            "--sampled-share", "0.5"])
    w, sched = tmain.build(args)
    assert twl.schedule_fingerprint(tmain.build(args)[1]) == twl.schedule_fingerprint(sched)
    temps = [r.body["temperature"] for r in sched]
    assert 0 < temps.count(0.0) < len(temps) and set(temps) == {0.0, 0.8}
    for r in sched:  # a greedy body's key is build_schedule's key for that body
        if r.body["temperature"] == 0.0:
            greedy = twl.build_schedule(dataclasses.replace(w, temperature=0.0))[r.index]
            assert (r.body, r.body_key) == (greedy.body, greedy.body_key)
    full = tmain.build(tmain.build_parser().parse_args(["--url", "http://x", "--temperature", "0.8"]))[1]
    assert twl.schedule_fingerprint(full) == jwl.schedule_fingerprint(jwl.build_schedule(jwl.Workload(
        temperature=0.8)))


def test_cli_selfhost_asserts(tmp_path, capsys):
    """``--self-host --device cpu --assert`` on the tiny model: exit 0, every
    request completed, the server's counters moved with the traffic."""
    import json

    from distributed_llama_tpu_torch import telemetry

    out = tmp_path / "report.json"
    try:
        code = tmain.main(["--self-host", "--device", "cpu", "--requests", "8", "--rate", "40", "--warmup", "1",
                           "--parallel", "2", "--admission-queue", "8", "--temperature", "0.8", "--sampled-share", "0.5",
                           "--assert",
                           "--expect-zero", "dllama_host_sampler_fallback_total",
                           "--expect-delta", "dllama_ttft_seconds_count:8", "--out", str(out)])
    finally:
        telemetry.disable()
        telemetry.reset()
    assert code == 0
    report = json.loads(out.read_text())
    assert report["schedule"]["replay_verified"] is True
    assert report["aggregate"]["counts"]["completed"] == 8
    assert report["server"]["dllama_prefix_cache_hits_total"] + report["server"][
        "dllama_prefix_cache_misses_total"] == 8
    assert report["client_vs_server_skew"]["default"]["completed"] == 8


def test_selfhost_completions_equal_jax():
    """The same schedule against the JAX self-host and the port's (f32 tiny
    model, two batched lanes, prefix cache): identical completion texts,
    greedy and sampled."""
    from distributed_llama_tpu import telemetry as jtel
    from distributed_llama_tpu.loadgen.selfhost import start_selfhost as jax_selfhost

    from distributed_llama_tpu_torch import telemetry as ttel
    from distributed_llama_tpu_torch.loadgen.selfhost import start_selfhost

    w = twl.Workload(n_requests=8, rate_rps=50.0, temperature=0.8, seed=3)
    sched = tmain.with_sampled_share(twl.build_schedule(w), 0.5, 3)
    texts = []
    for start, tel in ((lambda: jax_selfhost(parallel=2, admission_queue=8), jtel),
                       (lambda: start_selfhost(parallel=2, admission_queue=8, device="cpu"), ttel)):
        host = start()
        try:
            results, _ = trun.run_schedule(host.url, sched, timeout_s=120.0)
        finally:
            host.stop()
            tel.disable()
            tel.reset()
        assert all(r.outcome == "completed" for r in results), [r.outcome for r in results]
        texts.append([r.content for r in results])
    assert texts[1] == texts[0]
    assert {r.body["temperature"] for r in sched} == {0.0, 0.8}


@pytest.mark.parametrize("seed", range(3))
def test_check_isolation_equal(seed):
    """The two-phase isolation check on the same seeded results: equal
    verdicts, limits and p99s, including a tenant with no samples."""
    for tenant, bound, slack in (("gold", 10.0, 1000.0), ("default", 1.5, 0.0), ("absent", 10.0, 1000.0)):
        want = jrep.check_isolation(tenant, _results(jrun, seed), _results(jrun, seed + 7), bound=bound,
                                    slack_ms=slack)
        assert trep.check_isolation(tenant, _results(trun, seed), _results(trun, seed + 7), bound=bound,
                                    slack_ms=slack) == want


@pytest.mark.parametrize("extra,gate", [
    (["--faults", "batch.row:kind=nan,row=1,count=1", "--expect-delta", "dllama_rows_quarantined_total:1"],
     "expected_deltas"),
    (["--tenants", "gold:share=0.5,priority=5;free:share=0.5", "--isolation", "gold", "--isolation-slack-ms",
      "60000"], "isolation"),
], ids=["faults", "isolation"])
def test_cli_selfhost_faults_tenants_isolation(tmp_path, extra, gate):
    """``--self-host --device cpu`` with a row fault (armed after warmup: it
    fires once in the measured window), then with two tenants, one of
    priority 5, and ``--isolation gold``: the gate passes and every
    arrival is accounted."""
    import json

    from distributed_llama_tpu_torch import telemetry

    out = tmp_path / "report.json"
    try:
        code = tmain.main(["--self-host", "--device", "cpu", "--requests", "8", "--rate", "40", "--warmup", "1",
                           "--parallel", "2", "--admission-queue", "16", *extra, "--out", str(out)])
    finally:
        telemetry.disable()
        telemetry.reset()
    assert code == 0
    report = json.loads(out.read_text())
    assert report["checks"][gate]["ok"]
    assert sum(report["aggregate"]["counts"].values()) == 8
