"""``python -m distributed_llama_tpu_torch.loadgen`` — drive a server, print
the SLO report.

The port's copy of the JAX package's loadgen CLI. Examples:

  # CPU-scale zero-to-report: tiny synthetic model, in-process server
  python -m distributed_llama_tpu_torch.loadgen --self-host --device cpu \\
      --requests 16 --rate 20 --assert --out loadgen-report.json

  # a running server (the report scrapes <url>/metrics for deltas), with
  # half the requests sampled at temperature 0.8 and half greedy
  python -m distributed_llama_tpu_torch.loadgen --url http://127.0.0.1:9990 \\
      --temperature 0.8 --sampled-share 0.5 --assert

  # chaos under load, and the two-phase isolation proof for tenant "gold"
  ... --self-host --device cpu --faults "batch.row:kind=nan,row=1,after=2,count=1"
  ... --self-host --device cpu --tenants "gold:share=0.3,priority=5;free:share=0.7" --isolation gold

  # a replica kill under load: two self-hosted replicas, replica 0 crashes
  # mid-window, the victims replay on replica 1, the flight recorder shows it
  ... --self-host --device cpu --replicas 2 --faults "replica.crash:kind=raise,row=0,after=8,count=1" \\
      --expect-flight fault_fire@replica.crash:1 --expect-flight failover:1

Options whose subsystem the port has not yet (pods, the integrity canary
and shadow votes, rollouts) raise ValueError naming their ROADMAP.md item.

Exit codes: 0 = report produced (all asserted checks passed), 1 = an
``--assert``/``--isolation`` check failed, 2 = the run itself failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import random
import sys
import time

from distributed_llama_tpu_torch.loadgen import report as rep
from distributed_llama_tpu_torch.loadgen import runner, workload

# the ROADMAP.md item of each option whose subsystem is not ported
_FLEET = "ROADMAP.md Queue 1: the replica pool's canary, shadow votes and rollout"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributed_llama_tpu_torch.loadgen",
        description="deterministic load generator for the port's API server",
    )
    tgt = p.add_mutually_exclusive_group(required=True)
    tgt.add_argument("--url", type=str, help="base URL of a running server")
    tgt.add_argument("--self-host", action="store_true",
                     help="serve a tiny synthetic model in-process (--device picks the card or the CPU)")
    # workload shape (defaults = the JAX package's CI smoke)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--rate", type=float, default=16.0, help="arrival rate rps")
    p.add_argument("--arrival", choices=("poisson", "burst", "uniform"), default="poisson")
    p.add_argument("--burst-size", type=int, default=8)
    p.add_argument("--burst-period-s", type=float, default=1.0)
    p.add_argument("--prefixes", type=int, default=4, help="Zipf-shared prompt prefix pool size")
    p.add_argument("--zipf-s", type=float, default=1.1)
    p.add_argument("--prefix-chars", type=int, default=48)
    p.add_argument("--suffixes", type=int, default=6)
    p.add_argument("--suffix-chars", type=int, default=12)
    p.add_argument("--tenants", type=str, default=None,
                   help="tenant mix: 'name:share=S,priority=P,deadline_ms=D,slo_ttft_ms=T,slo_e2e_ms=E,"
                   "max_tokens=M;...' (default: one 'default' tenant)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="request-body temperature (0 = greedy; > 0 drives the device-sampled decode path with "
                   "pinned seeds)")
    p.add_argument("--topp", type=float, default=0.9, help="request-body top_p for sampled traffic")
    p.add_argument("--topk", type=int, default=0, help="request-body top_k for sampled traffic (0 = off)")
    p.add_argument("--sampled-share", type=float, default=1.0,
                   help="fraction of requests that take --temperature; the rest are greedy, chosen by a draw "
                   "from --seed (1.0 = all, as the JAX package's CLI)")
    # driving
    p.add_argument("--max-inflight", type=int, default=128)
    p.add_argument("--timeout-s", type=float, default=120.0)
    p.add_argument("--warmup", type=int, default=3,
                   help="sequential unmeasured requests before the open loop (first-call costs land outside "
                   "the measured window)")
    # self-host server knobs
    p.add_argument("--device", default="cuda", help="self-host device: cuda (default) or cpu")
    p.add_argument("--parallel", type=int, default=4, help="self-host serving slots (batch rows) per replica")
    p.add_argument("--replicas", type=int, default=None,
                   help="self-host supervised replicas (default 1): a replica-kill run composes this with --faults "
                   "'replica.crash:...' and gates on --expect-delta/--expect-flight")
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--kv-pages", type=int, default=None,
                   help="self-host prefix-cache pool budget in pages (default: slab-sized); a tiny value forces "
                   "eviction, spill and reload")
    p.add_argument("--host-spill-mb", type=float, default=16.0,
                   help="self-host host-RAM spill arena budget in MiB (--host-spill-mb on the server; 0 disables "
                   "the tier)")
    p.add_argument("--admission-queue", type=int, default=None,
                   help="self-host admission queue bound (default 2x --parallel)")
    p.add_argument("--server-tenants", type=str, default=None,
                   help="self-host --tenants spec (weights/priorities/queues); defaults to the workload tenants "
                   "at weight 1")
    p.add_argument("--faults", type=str, default=None,
                   help="self-host fault-plan spec (the server's --faults): chaos under load")
    p.add_argument("--faults-seed", type=int, default=0)
    p.add_argument("--no-preempt", action="store_true", help="self-host server without priority preemption")
    # not ported: each raises ValueError naming its ROADMAP.md item
    p.add_argument("--pod", type=str, default=None, help="not ported: raises")
    p.add_argument("--canary-interval-s", type=float, default=0.0, help="not ported: above 0 raises")
    p.add_argument("--shadow-rate", type=float, default=0.0, help="not ported: above 0 raises")
    p.add_argument("--rollout-weights", type=str, default=None, help="not ported: raises")
    p.add_argument("--expect-flight", action="append", default=[], metavar="KIND[@SITE][:MIN]",
                   help="assert the server's /debug/flight rings hold at least MIN (default 1) lifecycle events of "
                   "KIND, optionally with a given fault site, e.g. 'fault_fire@replica.crash:1' (the injection "
                   "landed in the black box) or 'failover:1' (the recovery it caused); repeatable")
    # report / checks
    p.add_argument("--out", type=str, default=None, help="report JSON path")
    p.add_argument("--assert", dest="assert_checks", action="store_true",
                   help="exit 1 unless fairness + consistency checks pass")
    p.add_argument("--isolation", type=str, default=None, metavar="TENANT",
                   help="two-phase isolation proof: run TENANT's arrivals alone, then the full mix; asserts "
                   "contended p99 TTFT <= bound x uncontended + slack")
    p.add_argument("--isolation-bound", type=float, default=10.0)
    p.add_argument("--isolation-slack-ms", type=float, default=1000.0)
    p.add_argument("--goodput-floor", type=float, default=None, metavar="FRACTION",
                   help="assert aggregate goodput_under_slo >= FRACTION")
    p.add_argument("--expect-delta", action="append", default=[], metavar="NAME:MIN",
                   help="assert a server counter's run delta moved at least MIN (default 1); repeatable")
    p.add_argument("--expect-zero", action="append", default=[], metavar="NAME",
                   help="assert a server counter's run delta did NOT move, e.g. "
                   "'dllama_host_sampler_fallback_total'; repeatable")
    return p


def check_ported(args) -> None:
    """Raise ValueError for an option whose subsystem the port lacks."""
    refused = [
        ("--pod", args.pod, "ROADMAP.md Queue 1 item 4 (sequence parallel, expert parallel and pod)"),
        ("--canary-interval-s", args.canary_interval_s > 0, _FLEET),
        ("--shadow-rate", args.shadow_rate > 0, _FLEET),
        ("--rollout-weights", args.rollout_weights is not None, _FLEET),
    ]
    for name, on, item in refused:
        if on:
            raise ValueError(f"{name} is not ported yet: {item}")
    if not 0.0 <= args.sampled_share <= 1.0:
        raise ValueError(f"--sampled-share must be in [0, 1], got {args.sampled_share}")


def make_workload(args) -> workload.Workload:
    return workload.Workload(
        seed=args.seed,
        n_requests=args.requests,
        rate_rps=args.rate,
        arrival=args.arrival,
        burst_size=args.burst_size,
        burst_period_s=args.burst_period_s,
        n_prefixes=args.prefixes,
        zipf_s=args.zipf_s,
        prefix_chars=args.prefix_chars,
        n_suffixes=args.suffixes,
        suffix_chars=args.suffix_chars,
        temperature=args.temperature,
        topp=args.topp,
        topk=args.topk,
        tenants=workload.parse_tenant_loads(args.tenants),
    )


def with_sampled_share(schedule: list, share: float, seed: int) -> list:
    """``schedule`` with the requests outside a ``share`` drawn from
    ``random.Random(seed)`` (one draw per request, in order) turned greedy:
    temperature 0, no top_p/top_k, body key recomputed as
    ``build_schedule`` computes it. A pure function of its arguments, so the replay
    fingerprint still holds; share 1.0 returns the schedule unchanged."""
    if share >= 1.0:
        return schedule
    rng = random.Random(seed)
    out = []
    for r in schedule:
        if rng.random() < share or r.body.get("temperature", 0.0) == 0.0:
            out.append(r)
            continue
        body = {k: v for k, v in r.body.items() if k not in ("top_p", "top_k")}
        body["temperature"] = 0.0
        key = hashlib.sha256(json.dumps(body, sort_keys=True).encode()).hexdigest()[:16]
        out.append(dataclasses.replace(r, body=body, body_key=key))
    return out


def settled_scrape(url: str, timeout_s: float = 10.0) -> dict[str, float]:
    """Scrape ``url``/metrics once the server's in-flight gauge reads 0: a
    client has its last byte before the handler thread counts the request
    (the port's server drops the gauge after every other request metric),
    so a scrape at once could miss the last requests' counts. Returns the
    last scrape after ``timeout_s`` (or {} when scraping fails, as
    :func:`report.scrape_metrics`)."""
    deadline = time.monotonic() + timeout_s
    while True:
        metrics = rep.scrape_metrics(url)
        if metrics.get("dllama_http_requests_in_flight", 0.0) == 0.0 or time.monotonic() >= deadline:
            return metrics
        time.sleep(0.01)


def build(args) -> tuple[workload.Workload, list]:
    w = make_workload(args)
    return w, with_sampled_share(workload.build_schedule(w), args.sampled_share, args.seed)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_ported(args)
    w, schedule = build(args)
    fingerprint = workload.schedule_fingerprint(schedule)
    # deterministic-replay proof: a second independent build of the same
    # (spec, seed) must fingerprint identically
    replay_ok = workload.schedule_fingerprint(build(args)[1]) == fingerprint
    host = None
    if args.self_host:
        from distributed_llama_tpu_torch.loadgen.selfhost import start_selfhost

        host = start_selfhost(parallel=args.parallel, seq_len=args.seq_len, kv_pages=args.kv_pages,
                              admission_queue=args.admission_queue, topk=args.topk, device=args.device,
                              tenants=args.server_tenants, preempt=not args.no_preempt, faults_spec=args.faults,
                              faults_seed=args.faults_seed, replicas=args.replicas,
                              host_spill_mb=args.host_spill_mb)
        url = host.url
        print(f"self-hosted server at {url}", file=sys.stderr)
    else:
        url = args.url.rstrip("/")
    try:
        if args.warmup > 0:
            warmed = runner.warm_server(url, schedule, n=args.warmup, timeout_s=max(args.timeout_s, 300.0))
            print(f"warmup: {warmed}/{args.warmup} completed", file=sys.stderr)
        if host is not None:
            # rule gates (after/count) count the measured window's hits
            host.reset_faults()
        solo_results = None
        if args.isolation:
            solo = [r for r in schedule if r.tenant == args.isolation]
            if not solo:
                print(f"isolation tenant {args.isolation!r} has no arrivals", file=sys.stderr)
                return 2
            # phase 1: the probe tenant alone, same instants (uncontended)
            solo_results, _ = runner.run_schedule(url, [dataclasses.replace(r, index=i) for i, r in enumerate(solo)],
                                                  max_inflight=args.max_inflight, timeout_s=args.timeout_s)
        before = rep.scrape_metrics(url)
        results, wall_s = runner.run_schedule(url, schedule, max_inflight=args.max_inflight,
                                              timeout_s=args.timeout_s)
        after = settled_scrape(url)
        report = rep.build_report(w, schedule, results, wall_s, fingerprint, replay_ok,
                                  metrics_before=before, metrics_after=after)
        if solo_results is not None:
            report["checks"]["isolation"] = rep.check_isolation(args.isolation, solo_results, results,
                                                                bound=args.isolation_bound,
                                                                slack_ms=args.isolation_slack_ms)
        if args.goodput_floor is not None:
            report["checks"]["goodput"] = rep.check_goodput(report, args.goodput_floor)
        if args.expect_delta:
            report["checks"]["expected_deltas"] = rep.check_expected_deltas(report, args.expect_delta)
        if args.expect_zero:
            report["checks"]["expected_zero"] = rep.check_expected_zero(report, args.expect_zero)
        if args.expect_flight:
            report["checks"]["expected_flight"] = rep.check_expected_flight(rep.fetch_flight(url),
                                                                            args.expect_flight)
        print(rep.dump_report(report, args.out))
        if not replay_ok:
            print("FATAL: schedule replay fingerprint mismatch", file=sys.stderr)
            return 2
        # explicitly requested gates are ALWAYS enforced; --assert adds the
        # built-in consistency and fairness checks
        gate_names = ("goodput", "expected_deltas", "expected_zero", "expected_flight")
        requested = [report["checks"].get(k) for k in gate_names]
        bad = [f"[{k}] {v}" for k, chk in zip(gate_names, requested) if chk and not chk.get("ok", True)
               for v in chk.get("violations", [])]
        if args.assert_checks or args.isolation:
            bad = rep.failed_checks(report)
        if bad:
            for v in bad:
                print(f"CHECK FAILED: {v}", file=sys.stderr)
            return 1
        if args.assert_checks or args.isolation or any(requested):
            print("all checks passed", file=sys.stderr)
        return 0
    finally:
        if host is not None:
            host.stop()


if __name__ == "__main__":
    sys.exit(main())
