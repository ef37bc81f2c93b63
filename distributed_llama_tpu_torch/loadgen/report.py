"""The SLO report: percentile summaries, goodput, server-metric deltas,
and the machine-checked invariants (fairness / consistency).

The port's copy of the JAX package's ``loadgen/report.py``: the same
report, byte for byte, from the same inputs, the two-phase isolation check,
the flight-recorder gate and the rollout gate.

The report is ONE JSON document (docs/SERVING.md defines the shape) built
from three inputs: the deterministic schedule, the measured per-request
results, and a before/after scrape of the server's ``/metrics`` — so
client-observed latency and server-side counters (preemptions,
quarantines, 429s, prefix-cache hits) land in the same artifact and can
be cross-checked.

Checks (each returns ``{"ok": bool, "violations": [...]}``, the CI gate
fails on any violation):

* **consistency** — greedy requests with byte-identical bodies must
  stream byte-identical content. Under a chaos plan this is the
  no-survivor-corruption proof: quarantined/errored requests are excluded,
  so any surviving mismatch is a real cross-request corruption.
* **fairness** — every tenant's arrivals are fully accounted (completed +
  rejected + deadline + errors + dropped == scheduled) and no tenant with
  scheduled work starved to zero completions while another tenant
  completed (the count-level starvation witness; the DRR share-convergence
  proof is deterministic and lives in tests/test_fair_sched.py).
"""

from __future__ import annotations

import json
import re
import urllib.request

from distributed_llama_tpu_torch.stats import percentile, summarize
from distributed_llama_tpu_torch.loadgen.runner import OUTCOMES, RequestResult
from distributed_llama_tpu_torch.loadgen.workload import (
    ScheduledRequest,
    Workload,
    scheduled_counts,
)

# server counters whose run delta lands in the report (labeled series are
# summed per base name; absent series read as 0 — telemetry may be off)
SERVER_COUNTERS = (
    "dllama_preemptions_total",
    "dllama_preempted_requeued_total",
    "dllama_rows_quarantined_total",
    "dllama_admission_rejected_total",
    "dllama_deadline_exceeded_total",
    "dllama_tenant_admitted_total",
    "dllama_tenant_rejected_total",
    # prefix-cache counter family: device-tier hit/miss/evict
    # plus the spill ladder and the cross-replica routing hits — a tiered-
    # cache chaos or capacity run gates on these (--expect-delta /
    # --expect-zero)
    "dllama_prefix_cache_hits_total",
    "dllama_prefix_cache_misses_total",
    "dllama_prefix_cache_evictions_total",
    "dllama_prefix_spill_pages_total",
    "dllama_prefix_spill_reloads_total",
    "dllama_prefix_spill_dropped_total",
    "dllama_prefix_shared_hits_total",
    # hit DEPTH, not just hit count: prompt tokens actually served from
    # cached pages over the window (the histogram's _sum series). The
    # hit/miss ratio alone can't see eviction damage when every prompt
    # shares a template-preamble block — this can
    "dllama_prefix_cache_matched_tokens_sum",
    "dllama_faults_injected_total",
    "dllama_watchdog_stalls_total",
    # replica-loss fault tolerance: the failover/replay ledger —
    # a replica-kill chaos run gates on these deltas (--expect-delta)
    "dllama_replica_failovers_total",
    "dllama_replica_restarts_total",
    "dllama_replayed_requests_total",
    # silent-data-corruption detection: the SDC chaos smoke
    # gates --expect-delta on mismatches/failovers and --expect-zero on
    # the clean run's mismatch counter (zero false positives)
    "dllama_sdc_checks_total",
    "dllama_sdc_mismatches_total",
    # device-resident sampling: the sampled-traffic smoke
    # gates --expect-delta on device-sampled tokens and --expect-zero on
    # the host-sampler fallback (the no-host-round-trip happy path)
    "dllama_device_sampled_tokens_total",
    "dllama_host_sampler_fallback_total",
    # server-side SLO attribution: the fairness smoke gates
    # --expect-delta on the TTFT count (server-side latency histograms
    # actually observed traffic); the skew section below reads the
    # per-tenant stage _sum series directly
    "dllama_ttft_seconds_count",
    "dllama_tpot_seconds_count",
    "dllama_request_stage_seconds_count",
    # zero-downtime fleet ops: the rollout smoke gates
    # --expect-delta on replicas moved and --expect-zero on aborts; the
    # elasticity smoke gates on scale events; the version info gauge
    # flips 0/1 per version label on rollout completion
    "dllama_rollout_replicas_moved_total",
    "dllama_rollout_aborts_total",
    "dllama_fleet_scale_events_total",
    "dllama_weights_version",
)


def parse_prometheus(text: str) -> dict[str, float]:
    """Minimal Prometheus text-exposition parser: ``name{labels} value``
    lines → {series: value}. Histogram sub-series keep their suffixed
    names; comments and blanks drop."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        try:
            out[name] = float(value)
        except ValueError:
            continue
    return out


def scrape_metrics(url: str, timeout_s: float = 10.0) -> dict[str, float]:
    """GET ``url``/metrics → parsed series. A scrape failure returns {}
    (the report then shows null deltas rather than aborting the run)."""
    try:
        with urllib.request.urlopen(url + "/metrics", timeout=timeout_s) as r:
            return parse_prometheus(r.read().decode())
    except OSError:
        return {}


def _sum_series(metrics: dict[str, float], base: str) -> float:
    """Sum every series of ``base`` across its label sets (exact-name
    match or ``base{...}``)."""
    return sum(
        v for k, v in metrics.items()
        if k == base or k.startswith(base + "{")
    )


def metric_deltas(
    before: dict[str, float], after: dict[str, float],
    names=SERVER_COUNTERS,
) -> dict[str, float]:
    return {
        n: round(_sum_series(after, n) - _sum_series(before, n), 3)
        for n in names
    }


_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def _sum_series_by_label(
    metrics: dict[str, float], base: str, label: str
) -> dict[str, float]:
    """Sum ``base{...}`` series grouped by one label's value (e.g. the
    per-tenant stage-attribution sums)."""
    out: dict[str, float] = {}
    for k, v in metrics.items():
        if not k.startswith(base + "{"):
            continue
        labels = dict(_LABEL_RE.findall(k[len(base):]))
        key = labels.get(label)
        if key is not None:
            out[key] = out.get(key, 0.0) + v
    return out


def client_server_skew(
    results: list["RequestResult"],
    before: dict[str, float], after: dict[str, float],
) -> dict:
    """Per-tenant client-vs-server skew: the sum of
    client-measured E2E over completed requests minus the run delta of
    the server-attributed `dllama_request_stage_seconds_sum` (all stages,
    that tenant). The difference is what the server cannot see — network,
    HTTP framing, client-side queuing. A large skew with healthy server
    attribution moves the investigation off the server process."""
    base = "dllama_request_stage_seconds_sum"
    srv_before = _sum_series_by_label(before, base, "tenant")
    srv_after = _sum_series_by_label(after, base, "tenant")
    out: dict[str, dict] = {}
    for tenant in sorted({r.tenant for r in results}):
        done = [
            r for r in results
            if r.tenant == tenant and r.outcome == "completed"
            and r.e2e_ms is not None
        ]
        client_s = sum(r.e2e_ms for r in done) / 1000.0
        server_s = srv_after.get(tenant, 0.0) - srv_before.get(tenant, 0.0)
        out[tenant] = {
            "completed": len(done),
            "client_e2e_s": round(client_s, 3),
            "server_attributed_s": round(server_s, 3),
            "skew_s": round(client_s - server_s, 3),
            "skew_per_request_ms": (
                round((client_s - server_s) / len(done) * 1000.0, 3)
                if done else None
            ),
        }
    return out


# ----------------------------------------------------------------------
# Aggregation
# ----------------------------------------------------------------------


def _summarize_group(
    results: list[RequestResult], wall_s: float,
    slo_ttft_ms: float | None = None, slo_e2e_ms: float | None = None,
) -> dict:
    counts = {o: 0 for o in OUTCOMES}
    for r in results:
        counts[r.outcome] += 1
    completed = [r for r in results if r.outcome == "completed"]
    good = [
        r for r in completed
        if (slo_ttft_ms is None or (r.ttft_ms or 0) <= slo_ttft_ms)
        and (slo_e2e_ms is None or (r.e2e_ms or 0) <= slo_e2e_ms)
    ]
    out = {
        "scheduled": len(results),
        "counts": counts,
        "ttft_ms": summarize([r.ttft_ms for r in completed if r.ttft_ms is not None]),
        "tpot_ms": summarize([r.tpot_ms for r in completed if r.tpot_ms is not None]),
        "e2e_ms": summarize([r.e2e_ms for r in completed if r.e2e_ms is not None]),
        "sched_lag_ms": summarize([r.sched_lag_ms for r in results]),
        "tokens_streamed": sum(r.n_deltas for r in completed),
        # goodput: completions INSIDE their SLO targets, as a rate and as
        # a fraction of everything that was scheduled (not of completions —
        # shed load must hurt the number, that is its job)
        "goodput_rps": round(len(good) / wall_s, 3) if wall_s > 0 else 0.0,
        "goodput_under_slo": (
            round(len(good) / len(results), 4) if results else 0.0
        ),
    }
    # the observed Retry-After values across 429/503 responses: more than
    # one distinct value is the visible proof the jitter satellite works
    # (a fixed header re-synchronizes every rejected client's retry)
    ras = sorted({
        r.retry_after for r in results if r.retry_after is not None
    })
    if ras:
        out["retry_after_s_seen"] = ras
    if slo_ttft_ms is not None or slo_e2e_ms is not None:
        out["slo"] = {"ttft_ms": slo_ttft_ms, "e2e_ms": slo_e2e_ms}
    return out


def build_report(
    workload: Workload,
    schedule: list[ScheduledRequest],
    results: list[RequestResult],
    wall_s: float,
    fingerprint: str,
    replay_verified: bool,
    metrics_before: dict[str, float] | None = None,
    metrics_after: dict[str, float] | None = None,
) -> dict:
    """Assemble the SLO report (docs/SERVING.md "Report format")."""
    slos = {t.name: (t.slo_ttft_ms, t.slo_e2e_ms) for t in workload.tenants}
    tenants: dict[str, dict] = {}
    for name in sorted({r.tenant for r in results}):
        rs = [r for r in results if r.tenant == name]
        ttft, e2e = slos.get(name, (None, None))
        tenants[name] = _summarize_group(rs, wall_s, ttft, e2e)
    report = {
        "workload": workload.spec_dict(),
        "schedule": {
            "fingerprint": fingerprint,
            "replay_verified": replay_verified,
            "n_requests": len(schedule),
            "per_tenant": scheduled_counts(schedule),
        },
        "wall_s": round(wall_s, 3),
        "aggregate": _summarize_group(results, wall_s),
        "tenants": tenants,
        "server": (
            metric_deltas(metrics_before, metrics_after)
            if metrics_before is not None and metrics_after is not None
            else None
        ),
        "client_vs_server_skew": (
            client_server_skew(results, metrics_before, metrics_after)
            if metrics_before is not None and metrics_after is not None
            else None
        ),
        "checks": {"consistency": check_consistency(results)},
    }
    report["checks"]["fairness"] = check_fairness(report)
    return report


# ----------------------------------------------------------------------
# Invariant checks
# ----------------------------------------------------------------------


def check_consistency(results: list[RequestResult]) -> dict:
    """Greedy determinism across the run: every group of byte-identical
    request bodies must have streamed byte-identical content. Only
    completed requests participate — under chaos, quarantined victims are
    EXPECTED casualties; a mismatch among the survivors is corruption."""
    groups: dict[str, set[str]] = {}
    sizes: dict[str, int] = {}
    for r in results:
        if r.outcome != "completed":
            continue
        groups.setdefault(r.body_key, set()).add(r.content)
        sizes[r.body_key] = sizes.get(r.body_key, 0) + 1
    violations = [
        f"body {k}: {sizes[k]} completions streamed "
        f"{len(variants)} distinct contents"
        for k, variants in groups.items()
        if len(variants) > 1
    ]
    return {
        "ok": not violations,
        "groups": len(groups),
        "repeated_groups": sum(1 for k in groups if sizes[k] > 1),
        "violations": violations,
    }


def check_fairness(report: dict) -> dict:
    """Count-level fairness/accounting invariants over the finished run
    (see module docstring)."""
    violations: list[str] = []
    tenants: dict[str, dict] = report.get("tenants", {})
    completed_anywhere = any(
        t["counts"]["completed"] > 0 for t in tenants.values()
    )
    for name, t in tenants.items():
        accounted = sum(t["counts"].values())
        if accounted != t["scheduled"]:
            violations.append(
                f"tenant {name!r}: {accounted} outcomes for "
                f"{t['scheduled']} scheduled arrivals (requests lost)"
            )
        if (
            completed_anywhere
            and t["scheduled"] > 0
            and t["counts"]["completed"] == 0
        ):
            violations.append(
                f"tenant {name!r} starved: 0 of {t['scheduled']} arrivals "
                "completed while other tenants were served"
            )
    return {"ok": not violations, "violations": violations}


def check_isolation(tenant: str, uncontended: list[RequestResult], contended: list[RequestResult],
                    bound: float = 10.0, slack_ms: float = 1000.0) -> dict:
    """Two-phase tenant-isolation check: tenant ``tenant``'s p99 TTFT under
    full contention must stay within ``bound x uncontended p99 +
    slack_ms`` (the slack absorbs noise where the uncontended p99 is a few
    milliseconds)."""
    solo = [r.ttft_ms for r in uncontended
            if r.tenant == tenant and r.outcome == "completed" and r.ttft_ms is not None]
    mixed = [r.ttft_ms for r in contended
             if r.tenant == tenant and r.outcome == "completed" and r.ttft_ms is not None]
    if not solo or not mixed:
        return {"ok": False,
                "violations": [f"tenant {tenant!r}: no completed samples in {'solo' if not solo else 'mixed'} phase"]}
    p99_solo = percentile(solo, 99)
    p99_mixed = percentile(mixed, 99)
    limit = bound * p99_solo + slack_ms
    ok = p99_mixed <= limit
    return {
        "ok": ok,
        "tenant": tenant,
        "uncontended_p99_ttft_ms": round(p99_solo, 3),
        "contended_p99_ttft_ms": round(p99_mixed, 3),
        "bound": bound,
        "slack_ms": slack_ms,
        "limit_ms": round(limit, 3),
        "violations": [] if ok else [
            f"tenant {tenant!r}: contended p99 TTFT {p99_mixed:.1f} ms exceeds {limit:.1f} ms ({bound}x "
            f"uncontended {p99_solo:.1f} ms + {slack_ms:.0f} ms slack)"
        ],
    }


def check_goodput(report: dict, floor: float) -> dict:
    """Aggregate goodput floor (the replica-kill chaos gate's teeth): the
    fraction of SCHEDULED arrivals that completed inside their SLO must
    not fall below ``floor`` — a failover that sheds the whole window
    (instead of replaying its victims on survivors) fails here even when
    every surviving stream is individually consistent."""
    got = report.get("aggregate", {}).get("goodput_under_slo", 0.0)
    ok = got >= floor
    return {
        "ok": ok,
        "goodput_under_slo": got,
        "floor": floor,
        "violations": [] if ok else [
            f"aggregate goodput {got:.3f} below the {floor:.3f} floor"
        ],
    }


def check_expected_deltas(report: dict, specs: list[str]) -> dict:
    """Gate on server-side counter movement: each spec is ``name:min`` —
    the run's /metrics delta for ``name`` must be ≥ ``min``. This is how
    a chaos smoke proves its fault actually FIRED (a replica-kill run
    with zero `dllama_replica_failovers_total` movement tested nothing)."""
    server = report.get("server") or {}
    violations: list[str] = []
    expected: dict[str, float] = {}
    for spec in specs:
        name, _, floor_s = spec.partition(":")
        name = name.strip()
        try:
            floor = float(floor_s) if floor_s.strip() else 1.0
        except ValueError:
            # a malformed MIN is a reportable violation, not a traceback
            # after minutes of traffic: the run's report must still land
            violations.append(
                f"malformed --expect-delta spec {spec!r} (want NAME:MIN)"
            )
            continue
        expected[name] = floor
        got = server.get(name)
        if got is None:
            violations.append(
                f"counter {name!r} not in the report's server deltas"
            )
        elif got < floor:
            violations.append(
                f"counter {name!r} moved {got:g}, expected >= {floor:g}"
            )
    return {"ok": not violations, "expected": expected,
            "violations": violations}


def check_expected_zero(report: dict, names: list[str]) -> dict:
    """Gate on server-side counter STILLNESS: each ``name``'s run delta
    must be exactly 0. The mirror image of :func:`check_expected_deltas`:
    a clean run proving `dllama_sdc_mismatches_total` did NOT
    move is the zero-false-positive witness — an integrity layer that
    cries wolf on healthy replicas would fail over the whole pool for
    nothing. An absent series reads as 0 (telemetry may be off)."""
    violations: list[str] = []
    server = report.get("server")
    if server is None:
        # a failed /metrics scrape would make every stillness claim
        # vacuously true — that is not a passing gate
        return {"ok": False, "expected_zero": list(names),
                "violations": ["no server metric deltas in the report"]}
    checked: list[str] = []
    for name in names:
        name = name.strip()
        if not name:
            continue
        checked.append(name)
        got = server.get(name, 0.0) or 0.0
        if got != 0:
            violations.append(
                f"counter {name!r} moved {got:g}, expected exactly 0"
            )
    return {"ok": not violations, "expected_zero": checked,
            "violations": violations}


def check_rollout(rollout: dict, results) -> dict:
    """The zero-downtime gate: the mid-window ``POST /admin/rollout``
    returned 200 (every replica moved, checksum- and canary-certified) and
    no request of the window failed (a request that straddled a drain
    finished on the old version or replayed on a survivor). 429s are
    admission shedding and stay out of it (the goodput floor judges them)."""
    violations: list[str] = []
    status = rollout.get("status")
    if status != 200:
        detail = rollout.get("error") or rollout.get("response")
        violations.append(f"POST /admin/rollout returned {status!r} ({detail!r}), expected 200")
    failed = [{"index": r.index, "tenant": r.tenant, "outcome": r.outcome, "status": r.status,
               "error_type": r.error_type}
              for r in results if r.outcome not in ("completed", "rejected_429")]
    violations.extend(f"request {f['index']} ({f['tenant']}) failed during the rollout window: {f['outcome']}"
                      for f in failed)
    return {"ok": not violations, "status": status, "response": rollout.get("response"),
            "failed_requests": failed, "violations": violations}


def fetch_flight(url: str, timeout_s: float = 10.0) -> dict | None:
    """GET ``url``/debug/flight -> the flight-recorder snapshot; None on
    failure (the gate then reports a violation, not a traceback)."""
    try:
        with urllib.request.urlopen(
            url + "/debug/flight", timeout=timeout_s
        ) as r:
            return json.loads(r.read().decode())
    except (OSError, ValueError):
        return None


def check_expected_flight(snapshot: dict | None, specs: list[str]) -> dict:
    """Gate on flight-recorder lifecycle events: each spec is
    ``kind[@site][:min]`` — at least ``min`` (default 1) events of
    ``kind`` (optionally with that ``site`` field, for `fault_fire`) must
    appear across the replica rings. A replica-kill run gates
    ``fault_fire@replica.crash:1`` and ``failover:1``: the black box must
    show the injection AND the recovery it caused."""
    violations: list[str] = []
    expected: list[dict] = []
    if snapshot is None:
        return {"ok": False, "expected": specs,
                "violations": ["/debug/flight snapshot unavailable"]}
    events = [
        ev for ring in (snapshot.get("replicas") or {}).values()
        for ev in ring
    ]
    for spec in specs:
        head, colon, floor_s = spec.rpartition(":")
        if not colon:
            head, floor_s = spec, ""
        try:
            floor = float(floor_s) if floor_s.strip() else 1.0
        except ValueError:
            violations.append(
                f"malformed --expect-flight spec {spec!r} "
                "(want KIND[@SITE][:MIN])"
            )
            continue
        kind, _, site = head.partition("@")
        kind, site = kind.strip(), site.strip()
        got = sum(
            1 for ev in events
            if ev.get("kind") == kind
            and (not site or ev.get("site") == site)
        )
        expected.append({"kind": kind, "site": site or None, "min": floor})
        if got < floor:
            violations.append(
                f"flight events kind={kind!r}"
                + (f" site={site!r}" if site else "")
                + f": saw {got}, expected >= {floor:g}"
            )
    return {"ok": not violations, "expected": expected,
            "violations": violations}


def failed_checks(report: dict) -> list[str]:
    """Flatten every check's violations (the CLI's --assert exit path)."""
    out: list[str] = []
    for name, chk in (report.get("checks") or {}).items():
        if chk and not chk.get("ok", True):
            out.extend(f"[{name}] {v}" for v in chk.get("violations", []))
    return out


def dump_report(report: dict, path: str | None) -> str:
    text = json.dumps(report, indent=2, sort_keys=False)
    if path:
        with open(path, "w") as f:
            f.write(text + "\n")
    return text
