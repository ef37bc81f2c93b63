"""Unified telemetry: metrics registry + span tracer + exposition.

The port's copy of the JAX package's ``telemetry/__init__.py``. One
process-global :class:`~distributed_llama_tpu_torch.telemetry.registry.MetricsRegistry`
and one :class:`~distributed_llama_tpu_torch.telemetry.tracer.SpanTracer`
back every instrument in the engine, the batch scheduler, the prefix cache,
the host sampler, the kernel wrappers and the API server. Metric names,
help strings, label names and buckets are the JAX package's, so one
dashboard reads both; ``dllama_kernel_path_total`` keeps its name and
labels but names the port's paths and counts each wrapper call.

Toggling
--------
Telemetry is OFF by default. Enable with the ``--telemetry`` CLI flag
(the CLI and the API server) or ``DLLAMA_TELEMETRY=1`` in the environment
(read once at import). ``enable()`` / ``disable()`` switch the process at
runtime, but instruments are BOUND at component construction: code binds
once (engine ``__init__``, scheduler, prefix cache, sampler, server
startup) via :func:`counter` / :func:`gauge` / :func:`histogram` / the
``span`` factory, and gets back

* the real registry-registered instrument when telemetry is enabled, or
* a shared null singleton whose methods are no-ops when it is disabled.

That bind-once contract is the zero-overhead-when-disabled design: the hot
decode loop holds direct attribute references, pays one no-op method call
per *dispatch* (never per token), performs no dict lookups, and never
mutates the registry. Components constructed before ``enable()`` keep their
null instruments — construct (or rebind) after enabling. The one per-call
site, :func:`note_kernel_path`, costs one flag check when disabled.

No instrument or span synchronizes the device.
"""

from __future__ import annotations

import os
import time

from distributed_llama_tpu_torch.telemetry.registry import (  # noqa: F401  (re-export)
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from distributed_llama_tpu_torch.telemetry.tracer import (  # noqa: F401  (re-export)
    NULL_SPAN,
    SpanTracer,
)

REGISTRY = MetricsRegistry()
TRACER = SpanTracer()

_ENV_VAR = "DLLAMA_TELEMETRY"
_enabled = os.environ.get(_ENV_VAR, "").strip().lower() in ("1", "true", "on", "yes")


def is_enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Clear the registry, the span ring buffer and the kernel-path series
    bound so far (tests)."""
    REGISTRY.reset()
    TRACER.clear()
    _kernel_paths.clear()


# ----------------------------------------------------------------------
# Null instruments: the disabled-mode bind targets. One shared stateless
# singleton per kind — no locks, no values, no registry entry. Tradeoff:
# .labels(...) cannot validate label NAMES here (the shared singleton
# knows no declaration, and a per-call check would tax the disabled hot
# path), so a labelnames typo only surfaces when telemetry is enabled —
# every labelled call site is covered by an enabled-mode test
# (tests/test_torch_telemetry.py, tests/test_torch_loadgen.py).
# ----------------------------------------------------------------------


class _NullCounter:
    __slots__ = ()
    value = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def labels(self, **kw):
        return self


class _NullGauge:
    __slots__ = ()
    value = 0.0

    def set(self, v: float) -> None:
        pass

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def labels(self, **kw):
        return self


class _NullHistogram:
    __slots__ = ()
    count = 0
    sum = 0.0

    def observe(self, v: float) -> None:
        pass

    def labels(self, **kw):
        return self


NULL_COUNTER = _NullCounter()
NULL_GAUGE = _NullGauge()
NULL_HISTOGRAM = _NullHistogram()


def counter(name: str, help: str = "", labelnames=()) -> Counter | _NullCounter:
    if not _enabled:
        return NULL_COUNTER
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames=()) -> Gauge | _NullGauge:
    if not _enabled:
        return NULL_GAUGE
    return REGISTRY.gauge(name, help, labelnames)


def histogram(
    name: str, help: str = "", labelnames=(), buckets=DEFAULT_LATENCY_BUCKETS
) -> Histogram | _NullHistogram:
    if not _enabled:
        return NULL_HISTOGRAM
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)


def _null_span(name: str, **args):
    return NULL_SPAN


def _real_span(name: str, **args):
    return TRACER.span(name, **args)


def span_factory():
    """The span entry point to BIND at construction time: returns either the
    live tracer's span() or a factory handing out the shared no-op span."""
    return _real_span if _enabled else _null_span


def trace_span(name: str, **args):
    """``with trace_span("decode", step=pos):`` — checks the enable flag per
    call; hot paths should bind :func:`span_factory` once instead."""
    return (_real_span if _enabled else _null_span)(name, **args)


def prometheus_text() -> str:
    return REGISTRY.prometheus_text()


def chrome_trace() -> dict:
    return TRACER.chrome_trace()


def export_chrome_trace(path: str) -> str:
    return TRACER.export_chrome_trace(path)


# ----------------------------------------------------------------------
# Shared wall-clock helper: the one copy of the perf-timing pattern the
# engine, the scheduler, the CLI and the server use.
# ----------------------------------------------------------------------


class Stopwatch:
    """``sw = Stopwatch(); ...; ms = sw.elapsed_ms()`` — monotonic, restartable."""

    __slots__ = ("_t0",)

    def __init__(self):
        self._t0 = time.perf_counter()

    def restart(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed_s(self) -> float:
        return time.perf_counter() - self._t0

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1000.0


# ----------------------------------------------------------------------
# Instrument bundles: each subsystem binds its instruments in one place so
# hot code holds plain attributes (and can skip whole blocks on .enabled).
# ----------------------------------------------------------------------


class EngineInstruments:
    """The engine's metric surface (bound once per InferenceEngine; the
    batch scheduler feeds its engine's bundle)."""

    def __init__(self):
        self.enabled = _enabled
        self.span = span_factory()
        self.tokens_generated = counter(
            "dllama_tokens_generated_total",
            "Decoded (generated) tokens across all engine streams",
        )
        self.prompt_tokens = counter(
            "dllama_prompt_tokens_total",
            "Prompt tokens prefilled across all engine streams",
        )
        self.prefill_latency = histogram(
            "dllama_prefill_latency_seconds",
            "Wall time of one batched prefill (dispatch+fetch, whole prompt)",
        )
        self.decode_latency = histogram(
            "dllama_decode_latency_seconds",
            "PER-TOKEN decode wall time, observed once per device dispatch "
            "(a chunked dispatch contributes one observation at its per-token "
            "average; dllama_tokens_generated_total counts the tokens)",
        )
        # device-resident sampling: tokens whose draw ran inside the device
        # step (no logits fetch, no host sort);
        # dllama_host_sampler_fallback_total counts the complement
        self.device_sampled_tokens = counter(
            "dllama_device_sampled_tokens_total",
            "Tokens sampled on device by the fused decode-scan sampler "
            "(greedy argmax rows included); only int32 token ids crossed "
            "the host for these",
        )
        self.kv_occupancy = gauge(
            "dllama_kv_cache_occupancy",
            "KV-cache occupancy of the most recently active stream "
            "(position / seq_len, 0..1)",
        )
        self.active_streams = gauge(
            "dllama_engine_streams",
            "Engine streams constructed (each owns one KV cache of HBM)",
        )
        self.batch_occupancy = gauge(
            "dllama_batch_occupancy",
            "Active rows / dispatched bucket rows of the most recent batched "
            "decode chunk (0..1; 1.0 = every slab row in the bucket is a "
            "live request sharing the step's weight reads)",
        )
        # fault containment: quarantines, retries, stalls, preemptions
        self.rows_quarantined = counter(
            "dllama_rows_quarantined_total",
            "Batch rows retired after a failed or corrupted chunk "
            "(bounded retries exhausted); co-batched rows kept streaming",
        )
        batch_retries = counter(
            "dllama_batch_retries_total",
            "Batched dispatch/fetch attempts retried after a transient "
            "failure (bounded, with backoff)",
            labelnames=("stage",),
        )
        self.dispatch_retries = batch_retries.labels(stage="dispatch")
        self.fetch_retries = batch_retries.labels(stage="fetch")
        self.watchdog_stalls = counter(
            "dllama_watchdog_stalls_total",
            "Hung batched chunks the stall watchdog failed cleanly",
        )
        self.preemptions = counter(
            "dllama_preemptions_total",
            "Decode rows evicted by a higher-priority arrival and requeued "
            "(clean RowPreempted evictions; a chaos-failed eviction counts "
            "as a quarantine instead)",
        )
        # speculative decoding (--spec-draft): draft volume, acceptance and
        # per-step advance — the health read is accepted/draft (the
        # prompt-lookup hit rate) and the advance histogram's mass above 1
        # (how many weight reads the drafts actually saved)
        self.spec_draft_tokens = counter(
            "dllama_spec_draft_tokens_total",
            "Prompt-lookup draft tokens proposed to speculative verify steps",
        )
        self.spec_accepted_tokens = counter(
            "dllama_spec_accepted_tokens_total",
            "Draft tokens accepted by speculative verify (excludes the "
            "per-step bonus/correction token)",
        )
        self.spec_acceptance = histogram(
            "dllama_spec_acceptance_ratio",
            "Accepted/drafted ratio per speculative verify step that "
            "proposed at least one draft token (0..1)",
            buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
        )
        self.spec_step_advance = histogram(
            "dllama_spec_step_advance_tokens",
            "Positions advanced per row per speculative verify step "
            "(accepted drafts + 1; plain decode is identically 1)",
            buckets=(1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 32.0),
        )


class PrefixCacheInstruments:
    """The radix prefix cache's metric surface (bound once per PrefixCache),
    with the host spill tier's series."""

    # matched-prefix length is a token count, not a latency: power-of-two
    # buckets up to a 16k context
    MATCHED_TOKEN_BUCKETS = (
        1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
        1024.0, 2048.0, 4096.0, 8192.0, 16384.0,
    )

    def __init__(self):
        self.enabled = _enabled
        self.hits = counter(
            "dllama_prefix_cache_hits_total",
            "Admission prefills that reused at least one published KV page "
            "(the matched prefix skipped recomputation)",
        )
        self.misses = counter(
            "dllama_prefix_cache_misses_total",
            "Admission prefills that matched no published prefix page",
        )
        self.evictions = counter(
            "dllama_prefix_cache_evictions_total",
            "KV pages reclaimed from the radix tree by the LRU evictor "
            "(leaf-first; refcounted pages are never evicted)",
        )
        self.pages = gauge(
            "dllama_prefix_cache_pages",
            "KV pages currently held by the radix tree (the pool size "
            "--kv-pages bounds this; free = pool - this)",
        )
        self.bytes = gauge(
            "dllama_prefix_cache_bytes",
            "Logical KV bytes held by the radix tree's pool pages (pages "
            "gauge x per-page bytes across all layers and both halves) — "
            "with zero-copy aliasing this is the ONLY resident copy of "
            "cached prefixes",
        )
        self.pinned_pages = gauge(
            "dllama_prefix_cache_pinned_pages",
            "Pool pages ref-pinned against eviction — held for the "
            "lifetime of rows reading them zero-copy through their page "
            "tables (plus publishes in flight)",
        )
        self.copy_bytes_saved = counter(
            "dllama_prefix_cache_copy_bytes_saved_total",
            "HBM copy traffic avoided by zero-copy paged attention: bytes "
            "the copy design would have gathered into the slab row per "
            "prefix hit (matched pages x per-page bytes)",
        )
        self.matched_tokens = histogram(
            "dllama_prefix_cache_matched_tokens",
            "Prompt tokens satisfied from the prefix cache per hit "
            "(page-granular)",
            buckets=self.MATCHED_TOKEN_BUCKETS,
        )
        # the host-RAM / disk spill tier (engine/spill.py): the capacity
        # ladder below the device pool
        self.spill_pages = counter(
            "dllama_prefix_spill_pages_total",
            "Evicted prefix pages whose bytes spilled to the host-RAM "
            "arena instead of vanishing (data+scales verbatim for i8)",
        )
        self.spill_reloads = counter(
            "dllama_prefix_spill_reloads_total",
            "Spilled prefix pages re-uploaded into a device pool on a "
            "later admission match (re-upload ≪ re-prefill; CRC-verified)",
        )
        self.spill_dropped = counter(
            "dllama_prefix_spill_dropped_total",
            "Spilled prefix pages LOST from the capacity ladder: LRU "
            "overflow past the host/disk budgets, or a CRC mismatch "
            "detected at reload (the entry is dropped, the block "
            "prefills cold)",
        )
        self.spill_resident_pages = gauge(
            "dllama_prefix_spill_resident_pages",
            "Spilled pages currently resident in the arena (host RAM + "
            "disk tier), across all replicas",
        )
        self.spill_bytes = gauge(
            "dllama_prefix_spill_bytes",
            "Bytes currently resident in the host-RAM spill arena "
            "(the --host-spill-mb budget bounds this; disk-tier bytes "
            "are not included)",
        )


# (kernel, path) -> its labelled counter, bound at the first call after
# enable(); reset() drops them with the registry
_kernel_paths: dict = {}


def note_kernel_path(kernel: str, path: str) -> None:
    """Count one kernel-wrapper call by (kernel, path) —
    ``dllama_kernel_path_total``. The port has no trace time: every call of
    a wrapper counts. Paths: ``q40_matmul`` k1_dp4a / k1_mma / k3 / plain,
    ``paged_attention`` k2 / k2_i8 / einsum / plain, ``all_reduce`` k4_ring
    / k5_fused / psum / plain. Disabled, the call is one flag check; the
    labelled counter is looked up once per (kernel, path) and then held.
    The operational read: a ``plain`` or ``einsum`` series moving on a card
    means a hot path ran without its kernel."""
    if not _enabled:
        return
    child = _kernel_paths.get((kernel, path))
    if child is None:
        child = REGISTRY.counter(
            "dllama_kernel_path_total",
            "Kernel wrapper calls by kernel (q40_matmul / paged_attention / "
            "all_reduce) and the path that ran (k1_dp4a / k1_mma / k3 / k2 / "
            "k2_i8 / k4_ring / k5_fused: the CUDA kernels; einsum / psum: "
            "torch ops; plain: a kernel's plain PyTorch version); one count "
            "per call",
            labelnames=("kernel", "path"),
        ).labels(kernel=kernel, path=path)
        _kernel_paths[(kernel, path)] = child
    child.inc()


class CollectiveInstruments:
    """The parallel backends' transfer-probe surface (TransferProbeMixin)."""

    def __init__(self):
        self.enabled = _enabled
        self.span = span_factory()
        self.allreduce_latency = histogram(
            "dllama_allreduce_latency_seconds",
            "Measured per-token collective (all-reduce/all-gather) cost from "
            "the transfer probe, replayed on the real mesh",
        )
        self.allreduce_bytes = counter(
            "dllama_allreduce_bytes_total",
            "Estimated logical payload bytes moved by the collectives the "
            "transfer probe replayed (per-token estimate x probe tokens)",
        )
        self.probe_runs = counter(
            "dllama_transfer_probe_runs_total",
            "Transfer-probe measurements taken (engine cadence: ~1/512 tokens)",
        )


class MeshInstruments:
    """The named-mesh topology surface (bound at engine or pod build): how
    many ranks lie along each axis and how many weight bytes are
    resident."""

    def __init__(self):
        self.enabled = _enabled
        self.mesh_devices = gauge(
            "dllama_mesh_devices",
            "Devices along each named mesh axis of the serving backend "
            "(pod axes 'data'/'model'; classic 1-D backends 'tp'/'sp'/'ep')",
            labelnames=("axis",),
        )
        self.resident_weight_bytes = gauge(
            "dllama_resident_weight_bytes",
            "Logical weight bytes resident per group: 'pod' = the ONE "
            "params tree every mesh slice shares, 'per_replica' = that "
            "tree attributed across the pod's data slices (the N-engine "
            "pool's equivalent figure is one full tree PER replica)",
            labelnames=("group",),
        )


class ServerInstruments:
    """The API server's metric surface (bound once per ApiState), with the
    replica pool's series: health, failover, integrity (canary, shadow
    votes, rebuild checksums) and fleet operations (rollouts, scaling)."""

    def __init__(self):
        self.enabled = _enabled
        self.requests = counter(
            "dllama_http_requests_total",
            "HTTP requests by route and status code",
            labelnames=("route", "status"),
        )
        self.request_duration = histogram(
            "dllama_http_request_duration_seconds",
            "End-to-end completion-request wall time (monotonic clock)",
        )
        self.inflight = gauge(
            "dllama_http_requests_in_flight",
            "Completion requests currently being served",
        )
        self.queue_wait = histogram(
            "dllama_slot_queue_wait_seconds",
            "Time a completion request waited for a free engine stream slot",
        )
        self.admission_rejected = counter(
            "dllama_admission_rejected_total",
            "Completion requests rejected 429 because the bounded admission "
            "queue was full (clients should honor Retry-After)",
        )
        self.deadline_exceeded = counter(
            "dllama_deadline_exceeded_total",
            "Completion requests ended 504 because their deadline_ms expired "
            "(queued or mid-stream)",
        )
        self.draining = gauge(
            "dllama_server_draining",
            "1 while the server is draining (SIGTERM received: no new "
            "admissions, in-flight completions finishing)",
        )
        # multi-tenant fairness: per-tenant admission accounting behind the
        # weighted-fair queues (server/admission.py)
        self.tenant_admitted = counter(
            "dllama_tenant_admitted_total",
            "Completion requests admitted to a serving slot, by tenant "
            "(weighted-fair DRR dequeue; docs/SERVING.md)",
            labelnames=("tenant",),
        )
        self.tenant_rejected = counter(
            "dllama_tenant_rejected_total",
            "Completion requests rejected 429 at a full tenant (or global) "
            "admission queue, by tenant",
            labelnames=("tenant",),
        )
        self.tenant_queue_depth = gauge(
            "dllama_tenant_queue_depth",
            "Requests currently queued for admission, by tenant",
            labelnames=("tenant",),
        )
        self.tenant_active = gauge(
            "dllama_tenant_active",
            "Completion requests currently holding a serving slot, by tenant",
            labelnames=("tenant",),
        )
        self.preempt_requeues = counter(
            "dllama_preempted_requeued_total",
            "Preempted requests requeued through weighted-fair admission "
            "(each resumes from the prefix cache's published pages; pairs "
            "with dllama_preemptions_total on the eviction side)",
        )
        # replica-loss fault tolerance (server/replicas.py): per-replica
        # health plus the failover/restart/replay ledger
        self.replica_state = gauge(
            "dllama_replica_state",
            "Health of each data-parallel replica in the supervised pool: "
            "0 = healthy, 1 = suspect (skipped for new placements), "
            "2 = dead (failing over; the supervisor is restarting it)",
            labelnames=("replica",),
        )
        self.replica_failovers = counter(
            "dllama_replica_failovers_total",
            "Replicas declared dead by the pool (crash, or a stall the "
            "watchdog escalated); each failover requeues every in-flight "
            "request on the dead replica through fair admission",
        )
        self.replica_restarts = counter(
            "dllama_replica_restarts_total",
            "Dead replicas successfully rebuilt and returned to the pool "
            "by the jittered-backoff restart supervisor",
        )
        self.replayed_requests = counter(
            "dllama_replayed_requests_total",
            "Requests replayed on a surviving replica after their replica "
            "died mid-flight (pinned seed, sent SSE deltas suppressed — "
            "the stream is bit-identical to an unfaulted run)",
        )
        # placement routed by the shared radix index
        # (engine/prefix_cache.py SharedPrefixIndex)
        self.shared_prefix_hits = counter(
            "dllama_prefix_shared_hits_total",
            "Requests placed onto a replica because the shared radix "
            "index says it owns (part of) the prompt's published prefix "
            "chain — the cross-replica routing that keeps the Zipf head "
            "from being re-prefilled once per replica",
        )
        # integrity checks: canary probes, shadow votes and rebuild
        # weight-checksum verifications; mismatches by the check that caught
        # them
        self.sdc_checks = counter(
            "dllama_sdc_checks_total",
            "Conclusive integrity checks performed: canary golden "
            "comparisons, cross-replica shadow votes, and rebuild "
            "weight-checksum verifications (a clean fleet moves this "
            "without ever moving the mismatch counter)",
        )
        self.sdc_mismatches = counter(
            "dllama_sdc_mismatches_total",
            "Integrity checks that detected silent data corruption, by "
            "which check caught it (canary = pinned-greedy golden "
            "mismatch, shadow = cross-replica divergence, checksum = a "
            "rebuilt replica's weights disagree with the load-time "
            "reference)",
            labelnames=("check",),
        )
        self.canary_latency = histogram(
            "dllama_canary_latency_seconds",
            "Wall time of one SDC canary probe (pinned greedy prompt "
            "through the replica's real batched path on a reserved lane)",
        )
        # request-scoped SLO attribution (telemetry/trace.py): server-side
        # TTFT/TPOT so client p99s decompose without trusting the client
        # clock, plus the per-stage breakdown, observed from the same
        # timestamps as the trace tree
        self.ttft = histogram(
            "dllama_ttft_seconds",
            "Server-side time to first streamed token, by tenant "
            "(request arrival to the first SSE content delta; replays "
            "keep the original arrival instant)",
            labelnames=("tenant",),
        )
        self.tpot = histogram(
            "dllama_tpot_seconds",
            "Server-side mean time per output token after the first, by "
            "tenant ((last - first token instant) / (emitted - 1))",
            labelnames=("tenant",),
        )
        self.stage_seconds = histogram(
            "dllama_request_stage_seconds",
            "Per-request latency attribution by stage (queue = fair-"
            "admission wait, placement = replica/lane selection, prefill, "
            "decode = the streaming loop, replay = all stages of "
            "requeued re-attempts after a failover/preemption) and "
            "tenant; sums approximate dllama_http_request_duration_seconds",
            labelnames=("stage", "tenant"),
        )
        # fleet operations (server/fleet.py): the blue-green rollout and
        # elasticity ledger
        self.rollout_moved = counter(
            "dllama_rollout_replicas_moved_total",
            "Replicas moved to a new weight version by a blue-green "
            "rollout (drained, rebuilt on the new weights, checksum-"
            "verified and canary-certified against the new version's "
            "golden); rollback rebuilds do NOT count as moves",
        )
        self.rollout_aborts = counter(
            "dllama_rollout_aborts_total",
            "Rollouts aborted (checksum gate or canary certification "
            "failed on the new version, or the server began draining "
            "mid-rollout); each abort rolls every moved replica back to "
            "the old version and raises a typed RolloutAborted",
        )
        self.fleet_scale = counter(
            "dllama_fleet_scale_events_total",
            "Elastic replica-count changes applied by the FleetController "
            "(up = grew one replica under sustained queue pressure, "
            "down = drained and retired one idle replica); hysteresis "
            "keeps this counter quiet on a stable fleet",
            labelnames=("direction",),
        )
        self.weights_version_info = gauge(
            "dllama_weights_version",
            "Info gauge: 1 on the label of the pool's CURRENT weight "
            "version (the old version's label drops to 0 when a rollout "
            "completes, so a scrape always names exactly one live pool "
            "version; mid-rollout per-replica versions are in /readyz)",
            labelnames=("version",),
        )


class SamplerInstruments:
    """Host-sampler distribution counters (bound once per Sampler)."""

    def __init__(self):
        self.enabled = _enabled
        self.sampled = counter(
            "dllama_sampled_tokens_total",
            "Host-sampled tokens by method (greedy / topp); device-sampled "
            "tokens are counted by dllama_tokens_generated_total instead",
            labelnames=("method",),
        )
        # with the device sampler every decode token is drawn inside the
        # device step, so any host Sampler.sample() call is the fallback
        # path (--decode host, or a caller doing its own logits fetch)
        self.fallback = counter(
            "dllama_host_sampler_fallback_total",
            "Tokens sampled by the HOST Sampler (the --decode host "
            "fallback): every one paid a full-vocab logits fetch and a "
            "host sort the fused device sampler exists to delete; 0 on "
            "the device-resident happy path",
        )
