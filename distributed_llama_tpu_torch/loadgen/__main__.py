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

  # a live blue-green rollout mid-window: the self-host writes a second
  # model with identical bytes under version v1; zero failed requests and
  # the greedy streams equal across the upgrade
  ... --self-host --device cpu --replicas 2 --rollout-weights same --assert

  # the SDC canary and shadow votes under load, gated to no false positive
  ... --self-host --device cpu --replicas 2 --canary-interval-s 0.5 --shadow-rate 0.5 \\
      --expect-zero dllama_sdc_mismatches_total

  # a one-process pod: two slices of two tensor-parallel ranks over one
  # shared weights tree, slice 0 killed mid-window
  ... --self-host --device cpu --pod 2x2 --faults "replica.crash:kind=raise,row=0,after=8,count=1" --assert

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
import threading
import time
import urllib.error
import urllib.request

from distributed_llama_tpu_torch.loadgen import report as rep
from distributed_llama_tpu_torch.loadgen import runner, workload


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
    p.add_argument("--pod", type=str, default=None, metavar="DATAxMODEL",
                   help="self-host a one-process pod (e.g. 2x2): the replicas are the pod's DATA slices of MODEL "
                   "tensor-parallel ranks over one shared weights tree (--replicas 1 picks the consolidated pod)")
    p.add_argument("--canary-interval-s", type=float, default=0.0,
                   help="self-host SDC canary period (--sdc-canary-interval-s on the server): pinned greedy probes "
                   "per replica compared against their version's golden; 0 disables")
    p.add_argument("--shadow-rate", type=float, default=0.0,
                   help="self-host shadow-vote sampling fraction (--sdc-shadow-rate on the server)")
    p.add_argument("--rollout-weights", type=str, default=None, metavar="SPEC",
                   help="fire POST /admin/rollout mid-window. Self-host: 'same' writes a second synthetic model "
                   "with identical bytes under a new version id (the consistency check holds across the upgrade); "
                   "an integer writes different weights from that seed. URL mode: a weights path on the server, "
                   "passed in the rollout body")
    p.add_argument("--rollout-at", type=float, default=0.5, metavar="FRACTION",
                   help="when to fire the rollout, as a fraction of the last scheduled arrival's offset "
                   "(default 0.5 = mid-window)")
    p.add_argument("--rollout-version", type=str, default="v1", help="version id the rollout upgrades to")
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
    """Raise ValueError for an option the port cannot run (every
    subsystem the options name is ported; the bounds are checked here)."""
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
                              host_spill_mb=args.host_spill_mb, canary_interval_s=args.canary_interval_s,
                              shadow_rate=args.shadow_rate, rollout_weights=args.rollout_weights,
                              rollout_version=args.rollout_version, pod=args.pod)
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
        rollout_thread = None
        rollout_result: dict = {}
        if args.rollout_weights is not None:
            body = {"version": args.rollout_version}
            if not args.self_host:
                body["weights"] = args.rollout_weights  # the server resolves the path
            # mid-window, scaled to the schedule's span, so in-flight streams
            # straddle the upgrade
            delay_s = max(0.0, args.rollout_at * schedule[-1].at_s)
            rollout_thread = threading.Thread(target=_rollout_trigger,
                                              args=(url, body, delay_s, args.timeout_s, rollout_result),
                                              name="loadgen-rollout", daemon=True)
        before = rep.scrape_metrics(url)
        if rollout_thread is not None:
            rollout_thread.start()
        results, wall_s = runner.run_schedule(url, schedule, max_inflight=args.max_inflight,
                                              timeout_s=args.timeout_s)
        if rollout_thread is not None:
            # the POST is synchronous on the server: joined, every move (or
            # the rollback) is in the deltas scraped next
            rollout_thread.join(timeout=args.timeout_s)
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
        if rollout_thread is not None:
            report["checks"]["rollout"] = rep.check_rollout(rollout_result, results)
        print(rep.dump_report(report, args.out))
        if not replay_ok:
            print("FATAL: schedule replay fingerprint mismatch", file=sys.stderr)
            return 2
        # explicitly requested gates are ALWAYS enforced; --assert adds the
        # built-in consistency and fairness checks
        gate_names = ("goodput", "expected_deltas", "expected_zero", "expected_flight", "rollout")
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


def _rollout_trigger(url: str, body: dict, delay_s: float, timeout_s: float, out: dict) -> None:
    """Sleep to the rollout instant, then POST /admin/rollout and record
    (status, response JSON) into ``out``, on its own thread while the open
    loop keeps firing arrivals."""
    time.sleep(delay_s)
    req = urllib.request.Request(url + "/admin/rollout", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            out["status"] = r.status
            out["response"] = json.loads(r.read().decode() or "{}")
    except urllib.error.HTTPError as e:
        # a 4xx/5xx carries the server's JSON (the rollback summary)
        out["status"] = e.code
        try:
            out["response"] = json.loads(e.read().decode() or "{}")
        except Exception:
            out["response"] = None
    except Exception as e:  # a connection-level failure
        out["status"] = None
        out["error"] = f"{type(e).__name__}: {e}"


if __name__ == "__main__":
    sys.exit(main())
