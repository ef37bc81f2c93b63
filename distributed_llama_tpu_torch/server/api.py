"""OpenAI-compatible API server: POST /v1/chat/completions, GET /v1/models,
/healthz, /readyz, /metrics and /debug/trace/<request_id>.

    python -m distributed_llama_tpu_torch.server.api --model m.m --tokenizer t.t \\
        --parallel 4 [--port 9990] [--device cpu] [--telemetry] \\
        [--tp 2 [--allreduce ring] | --pod 2x2] [--sp 2 | --ep 2] \\
        [--replicas 2] [--host-spill-mb 64] [--spill-disk-dir DIR] \\
        [--tenants "gold:weight=4,priority=10;free:weight=1"] [--deadline-ms 30000] \\
        [--faults "batch.row:kind=nan,row=1,count=1"] [--sdc-canary-interval-s 30] \\
        [--sdc-shadow-rate 0.05] [--fleet-max-replicas 3 --fleet-interval-s 5]

The port's copy of the JAX package's ``server/api.py`` serving core: SSE
streaming and plain JSON responses, per-request temperature / top-p / top-k
/ seed / max_tokens / stop overrides, and the ``NaiveCache``
longest-message-prefix reuse of each lane's KV cache.

``--cache-dtype i8`` keeps the KV cache (slab and page pool) in int8 with
per-(slot, head) scales; ``--spec-draft k`` decodes speculatively with
prompt-lookup drafts, on batched and single-stream lanes alike.

``--parallel N`` (default 2) serves N completions concurrently. With N > 1
and ``--batch-decode`` (the default, with ``--decode device``) the N lanes
are rows of one :class:`~distributed_llama_tpu_torch.engine.batch.BatchScheduler`:
concurrent completions coalesce into one batched decode dispatch per chunk,
reading each weight matrix once per step for all of them, and with
``--prefix-cache`` (the default) repeated prompt prefixes are served from
the shared page pool. Otherwise each lane is its own
:class:`~distributed_llama_tpu_torch.engine.engine.EngineStream`.

Tensor parallelism: ``--tp N`` serves engines of N ranks on the one card
(the scheduler's slab and pool hold each rank's kv heads; the ranks' sums
take the ``--allreduce`` arm). Under ``--tp`` speculative decode and the
host spill tier are disabled with a warning, as in the JAX package.
``--pod DATAxMODEL`` serves a one-process pod (:mod:`parallel.pod`): the
pod group is the engine factory, one supervised replica per data slice,
every slice over ONE params tree of MODEL ranks, so a slice's rebuild never
reloads weights; an explicit ``--replicas 1`` serves the consolidated
one-domain pod (one replica), and a rollout's ``"weights"`` file is placed
as a second tree over the same backend (``PodGroup.sibling``), the old tree
freed when the rollout completes. ``--sp N`` and ``--ep N`` serve engines
whose backends have no batched path, as in the JAX package: the scheduler
refuses them, the server prints ``⚠️ batch decode disabled: ...`` and
serves each lane as an independent stream, and ``--replicas`` above 1 is
reduced to 1 with a warning.

Admission is weighted-fair (:mod:`server.admission`): a request queues
under its ``tenant`` (body field, default ``default``; ``--tenants`` sets
weights, priorities and per-tenant queue bounds), slots are granted
priority class first, then by deficit round-robin across tenants, and past
``--admission-queue`` waiters (default 2 x --parallel) or its tenant's bound
a request gets 429 with a jittered Retry-After (1 s plus up to
``--retry-after-jitter-s``). A granted request takes the free lane whose
chat-prefix cache matches best, through the replica pool
(:mod:`server.replicas`). A queued higher-priority arrival evicts the
globally lowest-priority decode row (``--no-preempt`` queues strictly); the
victim is requeued through fair admission and re-run from its prompt at
its pinned seed, the SSE deltas it already sent suppressed (at most
``MAX_PREEMPT_REQUEUES`` times, then 503).

Replicas: ``--replicas R`` serves R supervised replicas (each its own
engine, weights, batch scheduler, slab and page pool; ``--parallel`` lanes
each) behind one admission front end. Placement prefers chat affinity, then
the replica owning the longest published chain of the prompt in the shared
prefix index (load-discounted), then the least loaded; a replica walks
healthy -> suspect -> dead on slow dispatch round trips
(``--replica-suspect-s``), escalated stalls and crashes. A dead replica's
in-flight requests replay on a survivor at their pinned seeds with the
deltas already sent suppressed, so each client sees one continuous stream,
and a supervisor frees its card memory and rebuilds it with jittered
backoff (``--replica-restart-backoff-s``) behind a weight-checksum check.
The host spill tier (``--host-spill-mb``, default 64; 0 disables it, and
``--spill-disk-dir``/``--spill-disk-mb`` add an mmap'd disk tier) is one
arena shared by every replica: an evicted page's bytes spill there and
reload on a later match, into the same replica or a peer. The flight
recorder is always on: ``GET /debug/flight`` serves every replica's ring of
lifecycle events, and ``--flight-dump-dir`` writes a JSON dump on each
replica death.

Deadlines: ``deadline_ms`` in the body (or ``--deadline-ms``) becomes one
monotonic instant for queueing, prefill and decode: 504 when it expires in
the queue or before any token, a terminal SSE error event when it expires
mid-stream; a non-finite or non-positive value is 400. Faults: a row the
batch scheduler quarantines, a stall its watchdog
(``--stall-timeout-s``) declares, or an exhausted requeue ends its request
typed (500, or an SSE error event once streaming); co-batched requests are
unaffected. ``--faults`` installs a fault plan (:mod:`engine.faults`)
before anything binds it; ``--max-body-bytes`` caps request bodies (413).

Observability: ``/healthz`` is liveness; ``/readyz`` is 200, or 503 while
the server drains after SIGTERM (new completions get 503 + Retry-After,
in-flight ones finish). With ``--telemetry`` (or ``DLLAMA_TELEMETRY=1``)
``/metrics`` serves the process registry (engine, scheduler, prefix cache,
sampler, kernel paths, HTTP), every completion records a request trace
(lane queue wait, lane choice, prefix match, prefill, the shared decode
steps' per-row spans, SSE sends) kept by a seeded sampler
(``--trace-sample-rate``, always kept past ``--trace-slow-ttft-s``) and
served at ``/debug/trace/<id>`` (``?format=chrome`` for a Chrome trace),
and the server-side TTFT (the instant the first SSE content delta is
written, for a streamed request), TPOT and per-stage times land in
``dllama_ttft_seconds`` / ``dllama_tpot_seconds`` /
``dllama_request_stage_seconds`` under the request's tenant.

Integrity: the SDC canary (``--sdc-canary-interval-s``; 0, the default,
ticks only by hand) runs a pinned greedy prompt (``--sdc-canary-tokens``
tokens) through each replica's real batched path on a directly claimed lane
(billed to the reserved ``_integrity`` tenant, no admission permit, priority
below every class) and compares tokens and logit fingerprint with its
weight version's golden: ``--sdc-canary-threshold`` mismatches in a row
declare the replica dead as corrupt. A victim of such a loss that had sent
no delta replays; one that had gets a typed ``replica_corrupt`` error, never
a splice. ``--sdc-shadow-rate`` re-runs that share of completed greedy
requests on two replicas off the request path (one vote at a time); a
divergence turns both suspect until the canary resolves them. Client
tenant names may not start with ``_``.

Fleet operations (:mod:`server.fleet`): ``POST /admin/rollout`` with
``{"version": "v1"[, "weights": "/path/new.m"][, "checksum": "..."]}`` moves
the replicas to a new weight version one at a time (pin, cordon and drain
at most ``--rollout-drain-s``, rebuild behind the version's checksum,
certify under the ``_rollout`` tenant, uncordon) and answers 200, 409 (a
conflict, nothing started) or 500 (aborted and rolled back). The fleet
controller grows the pool under queue pressure up to
``--fleet-max-replicas`` and retires idle replicas down to
``--fleet-min-replicas``, ticking every ``--fleet-interval-s`` (0 ticks only
by hand). ``/readyz`` reports the pool's weights version, the rollout's
state and each replica's version, cordon and canary verdict.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import random
import signal
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from distributed_llama_tpu_torch import lockcheck, retry, telemetry
from distributed_llama_tpu_torch.engine import faults, integrity
from distributed_llama_tpu_torch.engine.faults import DeadlineExceeded
from distributed_llama_tpu_torch.server.admission import (
    DEFAULT_TENANT,
    AdmissionRejected,
    FairAdmission,
    ServerDraining,
    parse_tenants,
)
from distributed_llama_tpu_torch.server import fleet
from distributed_llama_tpu_torch.server.replicas import NoPlaceableReplica, Replica, ReplicaPool
from distributed_llama_tpu_torch.telemetry import Stopwatch, flight, trace
from distributed_llama_tpu_torch.telemetry.trace import RequestTraceStore
from distributed_llama_tpu_torch.tokenizer import (
    ChatItem,
    ChatTemplate,
    ChatTemplateType,
    EosDetector,
    EosDetectorResult,
    Sampler,
    Tokenizer,
    chat_stops,
    is_safe_piece,
)

MODEL_NAME = "Distributed Model"
MAX_BODY_BYTES = 1 << 20  # the default --max-body-bytes: larger bodies get 413 unread

# a preempted request requeues through fair admission at most this many
# times before the server answers 503 + Retry-After: a deadline-less
# victim under sustained higher-priority pressure must not requeue forever
MAX_PREEMPT_REQUEUES = 3

# the requeue loop in the retry vocabulary: N+1 attempts, no sleep between
# them (the fair admission queue is the backpressure)
REQUEUE_POLICY = retry.BackoffPolicy(attempts=MAX_PREEMPT_REQUEUES + 1)

# the canary's pinned prompt: what matters is that the same prompt decodes
# greedily through the real batched path on every replica, so (tokens,
# fingerprint) has one healthy value per weights version
CANARY_PROMPT = "integrity canary: count one two three four five"

# the canary row's priority, below every real class: a queued request
# preempts the probe (which then reports inconclusive) instead of waiting
CANARY_PRIORITY = -(1 << 30)


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


class BadRequest(ValueError):
    """Client error in a request body (HTTP 400)."""


@dataclasses.dataclass
class CacheItem:
    end_pos: int
    role: str
    content: str


class NaiveCache:
    """Longest-message-prefix chat cache of one lane."""

    def __init__(self):
        self.items: list[CacheItem] = []

    def push(self, end_pos: int, role: str, content: str) -> None:
        self.items.append(CacheItem(end_pos, role, content))

    def clear(self) -> None:
        self.items.clear()

    def resolve_delta_prompt(self, messages: list[dict]) -> tuple[int, list[dict]]:
        """Returns (start_pos, remaining_messages)."""
        if self.match_len(messages) == 0:
            self.clear()
            return 0, messages
        return self.items[-1].end_pos, messages[len(self.items):]

    def match_len(self, messages: list[dict]) -> int:
        """Number of cached messages this request would reuse (0 = none)."""
        n = len(self.items)
        if n == 0 or len(messages) <= n:
            return 0
        if all(self.items[i].role == messages[i]["role"] and self.items[i].content == messages[i]["content"]
               for i in range(n)):
            return n
        return 0


@dataclasses.dataclass
class StreamSlot:
    """One concurrent completion lane: an engine stream plus its chat-prefix
    cache and (host-decode) sampler. ``busy`` is guarded by the state's
    lane lock."""

    stream: object  # EngineStream or BatchStream
    cache: NaiveCache
    sampler: Sampler
    busy: bool = False
    tenant: str | None = None  # the occupying request's tenant (metrics)


class ApiState:
    def __init__(self, engine, tokenizer: Tokenizer, sampler: Sampler, args, engine_factory=None):
        self.tokenizer = tokenizer
        self.sampler = sampler  # lane 0's sampler; the others derive their seeds from it
        self.args = args
        self.stops = chat_stops(tokenizer)
        template_type = getattr(args, "chat_template", None) or ChatTemplateType.UNKNOWN
        self.template = ChatTemplate(template_type, tokenizer.chat_template, self.stops[0])
        # N lanes per replica over R replicas; each replica is one failure
        # domain (its own engine, scheduler slab and page pool) behind one
        # admission front door
        n = max(1, int(getattr(args, "parallel", 2) or 1))
        n_replicas = max(1, int(getattr(args, "replicas", 1) or 1))
        self._lanes = n
        # versioned engine factories: the boot factory under the boot
        # version; a rollout target registers through
        # register_weights_version or register_weights_path (on a pod, a
        # PodGroup: dropping it at the rollout's end frees its params tree)
        self._boot_version = str(getattr(args, "weights_version", None) or "v0")
        self._weights_versions: dict = {}
        if engine_factory is not None:
            self._weights_versions[self._boot_version] = engine_factory
        # weight-file path -> zero-argument engine factory (make_server
        # installs one), for POST /admin/rollout's "weights"
        self.make_engine_for_path = None
        if n_replicas > 1 and engine_factory is None:
            print("⚠️ replicas reduced to 1: no engine factory to build (or restart) more replicas")
            n_replicas = 1
        # replicas require the scheduler: it is the failure domain the pool
        # supervises; one lane on one replica keeps the single stream
        self._batch_wanted = (getattr(args, "batch_decode", True) and getattr(args, "decode", "device") == "device"
                              and (n > 1 or n_replicas > 1))
        # the shared cache tier, built before any replica so replica 0 wires
        # into it: one prefix index over every replica's tree (placement
        # routes to the owner of the longest published chain) and one
        # host-RAM spill arena (an mmap'd disk tier optional below it)
        self._shared_index = None
        self._spill_arena = None
        if self._batch_wanted and getattr(args, "prefix_cache", True):
            page_sz = getattr(args, "kv_page_size", 64)
            if n_replicas > 1 and page_sz and page_sz >= 1:
                from distributed_llama_tpu_torch.engine.prefix_cache import SharedPrefixIndex

                self._shared_index = SharedPrefixIndex(page_sz)
            spill_mb = getattr(args, "host_spill_mb", None)
            spill_mb = 64.0 if spill_mb is None else float(spill_mb)
            if spill_mb > 0:
                from distributed_llama_tpu_torch.engine.spill import HostArena

                disk_dir = getattr(args, "spill_disk_dir", None)
                disk_mb = float(getattr(args, "spill_disk_mb", 0) or 0)
                self._spill_arena = HostArena(
                    int(spill_mb * (1 << 20)),
                    disk_path=os.path.join(disk_dir, "dllama-kv-spill.bin") if disk_dir and disk_mb > 0 else None,
                    disk_budget_bytes=int(disk_mb * (1 << 20)))
        # replica 0 first: whether its backend has a batched path decides
        # whether more replicas make sense, before N-1 more weight loads
        replicas = [Replica(0, *self._build_replica(0, engine=engine))]
        if n_replicas > 1 and replicas[0].scheduler is None:
            # the sp/ep backends have no batched path, so no supervisable
            # scheduler: one replica rather than pretend
            print("⚠️ replicas reduced to 1: batch decode unavailable")
            n_replicas = 1
        replicas += [Replica(i, *self._build_replica(i)) for i in range(1, n_replicas)]
        aq = getattr(args, "admission_queue", None)
        self.queue_limit = max(0, int(aq)) if aq is not None else 2 * n * n_replicas
        mb = getattr(args, "max_body_bytes", None)  # 0 is a valid cap
        self.max_body_bytes = int(mb) if mb is not None else MAX_BODY_BYTES
        self.default_deadline_ms = getattr(args, "deadline_ms", None)
        # weighted-fair admission: one permit per lane, per-tenant bounded
        # queues, priority classes first (server/admission.py)
        self.tenants = parse_tenants(getattr(args, "tenants", None))
        self.admission = FairAdmission(n * n_replicas, tenants=self.tenants, queue_limit=self.queue_limit)
        # bound before the pool, so its replica-state gauges land in it
        self.tel = telemetry.ServerInstruments()
        # the bounded store behind GET /debug/trace/<id>; None with telemetry
        # off, so every per-request hook is one `ctx is None` check
        self.traces: RequestTraceStore | None = None
        if telemetry.is_enabled():
            sample = getattr(args, "trace_sample_rate", None)
            slow = getattr(args, "trace_slow_ttft_s", None)
            retention = getattr(args, "trace_retention", None)
            self.traces = RequestTraceStore(
                capacity=256 if retention is None else int(retention),
                sample_rate=1.0 if sample is None else float(sample),
                slow_ttft_s=1.0 if slow is None else float(slow),
            )
        # the flight recorder is always on: arm the fault-fire observer and
        # the optional on-death dump directory
        flight.install_fault_observer()
        dump_dir = getattr(args, "flight_dump_dir", None)
        if dump_dir:
            flight.RECORDER.dump_dir = str(dump_dir)
        # the supervised replica pool; supervision needs the factory (a
        # restart rebuilds the engine) and the scheduler (the failure
        # domain). No falsy-or on the replica flags: 0 is a valid setting
        suspect_s = getattr(args, "replica_suspect_s", None)
        restart_base = getattr(args, "replica_restart_backoff_s", None)
        self.pool = ReplicaPool(
            self._build_replica, replicas, admission=self.admission, tel=self.tel,
            supervise=engine_factory is not None and replicas[0].scheduler is not None,
            suspect_roundtrip_s=30.0 if suspect_s is None else float(suspect_s),
            restart_policy=retry.BackoffPolicy(attempts=retry.UNBOUNDED,
                                               base_s=0.5 if restart_base is None else float(restart_base),
                                               multiplier=2.0, max_s=30.0, jitter_s=0.5),
            shared_index=self._shared_index, spill_arena=self._spill_arena, weights_version=self._boot_version)
        if replicas[0].scheduler is not None and getattr(args, "preempt", True):
            # a queued higher-priority arrival may evict the lowest-priority
            # decode row on any live replica (called outside the admission lock)
            self.admission.preempt_hook = self.pool.preempt_below
        # jittered Retry-After: 1 s plus up to --retry-after-jitter-s,
        # drawn per response from an entropy-seeded RNG, so rejected
        # clients do not retry in lockstep
        self.retry_after_base_s = 1
        self.retry_after_jitter_s = max(0, int(getattr(args, "retry_after_jitter_s", 2) or 0))
        self._retry_rng = random.Random()
        # the SSE writer fires the server.send site through it
        self.faults = faults.active_plan()
        # requests ended by their deadline: a plain count beside
        # dllama_deadline_exceeded_total, readable with telemetry off
        self._count_lock = threading.Lock()
        self.deadline_exceeded_total = 0
        self.draining = False
        # the SDC canary: the pool's canary runs _canary_probe; 0 s arms the
        # probe for manual ticks and shadow votes only
        self.canary_prompt = getattr(args, "sdc_canary_prompt", None) or CANARY_PROMPT
        self.canary_tokens = int(getattr(args, "sdc_canary_tokens", 12) or 12)
        self.shadow_rate = float(getattr(args, "sdc_shadow_rate", 0.0) or 0.0)
        # entropy-seeded: it picks which greedy requests get a shadow vote
        self._shadow_rng = random.Random()
        # one shadow vote in flight at most; extra samples are dropped
        self._shadow_gate = threading.Semaphore(1)
        interval = getattr(args, "sdc_canary_interval_s", None)
        self.pool.start_canary(self._canary_probe, 0.0 if interval is None else float(interval),
                               fail_threshold=int(getattr(args, "sdc_canary_threshold", 2) or 2))
        # fleet operations share one non-blocking ops lock, so a rollout and
        # a scaling never change the fleet at once; elasticity is off unless
        # --fleet-max-replicas is above the boot count
        self._fleet_lock = lockcheck.make_lock("ApiState._fleet_lock")
        drain_s = getattr(args, "rollout_drain_s", None)
        self.rollout = fleet.RolloutOrchestrator(self, drain_timeout_s=15.0 if drain_s is None else float(drain_s),
                                                 ops_lock=self._fleet_lock)
        fleet_max = getattr(args, "fleet_max_replicas", None)
        self.fleet = fleet.FleetController(
            self, min_replicas=int(getattr(args, "fleet_min_replicas", None) or 1),
            max_replicas=int(fleet_max) if fleet_max is not None else len(self.pool.replicas),
            interval_s=float(getattr(args, "fleet_interval_s", None) or 0.0),
            queue_high=getattr(args, "fleet_queue_high", None), ops_lock=self._fleet_lock)
        # exactly one version label reads 1 (on_rollout_complete flips it)
        self.tel.weights_version_info.labels(version=self._boot_version).set(1)

    # ------------------------------------------------------------------
    # Versioned weights
    # ------------------------------------------------------------------

    def register_weights_version(self, version: str, factory, checksum: str | None = None) -> None:
        """Register a zero-argument engine factory for ``version`` (a
        rollout target). ``checksum`` pre-seeds its reference; otherwise its
        first build's load-time checksum records it."""
        self._weights_versions[str(version)] = factory
        if checksum is not None:
            self.pool.register_version(str(version), checksum)

    def has_weights_version(self, version: str) -> bool:
        return str(version) in self._weights_versions

    def register_weights_path(self, version: str, path: str) -> None:
        """Register ``version`` from a weight file (``POST /admin/rollout``'s
        ``"weights"``) through ``make_engine_for_path``."""
        if self.make_engine_for_path is None:
            raise RuntimeError("this server cannot load weight files at runtime (no path loader installed)")
        self.register_weights_version(version, self.make_engine_for_path(str(path)))

    def on_rollout_complete(self, old_version: str, new_version: str) -> None:
        """A rollout's end: drop the old version's factory (on a pod, the
        old PodGroup: its params tree goes with the last reference) and flip
        the version gauge."""
        self._weights_versions.pop(old_version, None)
        self.tel.weights_version_info.labels(version=old_version).set(0)
        self.tel.weights_version_info.labels(version=new_version).set(1)

    # replica 0's engine, scheduler and every lane: properties, so a
    # restarted replica's old engine is referenced from nowhere here
    @property
    def engine(self):
        return self.pool.replicas[0].engine

    @property
    def batch(self):
        """Replica 0's BatchScheduler (None without batched lanes)."""
        return self.pool.replicas[0].scheduler

    @property
    def slots(self) -> list[StreamSlot]:
        """Every replica's lanes, flattened."""
        return self.pool.all_slots()

    def _make_scheduler(self, engine, replica_id: int):
        """One replica's BatchScheduler from the serving flags, or None for
        independent streams (one lane on one replica, --no-batch-decode,
        --decode host, or a backend without a batched path: --sp and --ep,
        whose refusal is printed)."""
        if not self._batch_wanted:
            return None
        from distributed_llama_tpu_torch.engine.batch import BatchScheduler

        args = self.args
        try:
            return BatchScheduler(
                engine, n_rows=self._lanes, chunk=getattr(args, "decode_chunk", 32),
                stall_timeout_s=getattr(args, "stall_timeout_s", None),
                prefix_cache=getattr(args, "prefix_cache", True), kv_pages=getattr(args, "kv_pages", None),
                page_size=getattr(args, "kv_page_size", 64), prefill_chunk=getattr(args, "prefill_chunk", 256),
                spec_draft=getattr(args, "spec_draft", 0), spec_ngram=getattr(args, "spec_ngram", 3),
                replica_id=replica_id, spill_arena=self._spill_arena, shared_index=self._shared_index,
            )
        except ValueError as e:  # a backend without a batched path (sp/ep)
            print(f"⚠️ batch decode disabled: {e}")
            return None

    def _build_replica(self, idx: int, engine=None):
        """Build (or rebuild: the pool's supervisor calls this under the
        restart backoff, a rollout and a scale-up directly) replica ``idx``:
        an engine (the factory of the version the pool's target_version
        names, unless given), its scheduler and its lanes. Returns
        ``(engine, scheduler_or_None, slots)``. A version's first build
        records its load-time checksum as the version's reference, before
        any corruption can land. Lane sampler seeds stay distinct across
        replicas."""
        pool = getattr(self, "pool", None)
        version = pool.target_version(idx) if pool is not None else self._boot_version
        if engine is None:
            factory = self._weights_versions.get(version)
            if factory is None:
                raise RuntimeError(f"replica {idx} cannot be built: no engine factory for weights_version "
                                   f"{version!r}")
            engine = factory()
        if pool is not None and version not in pool.weights_reference:
            try:
                pool.register_version(version, engine.weights_checksum())
            except Exception as e:
                print(f"⚠️ weight checksum unavailable: {e}")
        sched = self._make_scheduler(engine, idx)
        if sched is not None:
            streams = [sched.new_stream() for _ in range(self._lanes)]
        else:
            streams = [engine.default_stream] + [engine.new_stream() for _ in range(self._lanes - 1)]
        base = self.sampler
        slots = [
            StreamSlot(s, NaiveCache(), base if idx == 0 and i == 0 else Sampler(
                vocab_size=base.vocab_size, temperature=base.temperature, topp=base.topp, topk=base.topk,
                seed=base.seed + idx * self._lanes + i))
            for i, s in enumerate(streams)
        ]
        return engine, sched, slots

    def _route_tokens(self, params: dict):
        """The full prompt's token ids for shared-index placement, or None
        when the index is off, empty, or the request opted out of the
        prefix cache (the re-encode is skipped until it can matter)."""
        if self._shared_index is None or len(self._shared_index) == 0 or params.get("cache", "on") == "off":
            return None
        items = [ChatItem(m["role"], m["content"]) for m in params["messages"]]
        return self.tokenizer.encode(self.template.generate(items, append_generation_prompt=True), add_bos=True)

    def _acquire_slot(self, messages: list[dict], deadline: float | None = None, tenant: str = DEFAULT_TENANT,
                      priority: int = 0, route_tokens=None, ctx=None) -> StreamSlot:
        """Take a lane through weighted-fair admission: when all are busy
        the request queues boundedly under its tenant (AdmissionRejected:
        429), grants go priority class first then deficit round-robin, a
        higher-priority arrival may preempt a lower-priority decode row
        (the admission hook), and a request whose deadline expires in line
        leaves with DeadlineExceeded (504). The replica pool then places the
        granted request (:meth:`ReplicaPool.place`)."""
        sw = Stopwatch()
        tel = self.tel
        try:
            with trace.span(ctx, "queue_wait"):
                self.admission.acquire(tenant, priority, deadline, trace=ctx)
        except AdmissionRejected:
            tel.admission_rejected.inc()
            tel.tenant_rejected.labels(tenant=tenant).inc()
            raise
        finally:
            tel.tenant_queue_depth.labels(tenant=tenant).set(self.admission.queue_depth(tenant))
        if self.draining:
            # a SIGTERM that landed while this request queued
            self.admission.release()
            raise ServerDraining("server is draining; not admitting")
        queue_s = sw.elapsed_s()
        tel.queue_wait.observe(queue_s)
        tel.tenant_admitted.labels(tenant=tenant).inc()
        tel.tenant_active.labels(tenant=tenant).inc()
        if ctx is not None:
            ctx.add_stage("queue", queue_s)
        sw.restart()
        try:
            with trace.span(ctx, "placement"):
                slot = self.pool.place(messages, deadline, route_tokens=route_tokens)
        except BaseException:
            # placement raced a replica death (or the deadline): the permit
            # goes back, and a ReplicaLost re-enters the requeue loop
            self.admission.release()
            tel.tenant_active.labels(tenant=tenant).dec()
            raise
        slot.tenant = tenant
        if ctx is not None:
            ctx.add_stage("placement", sw.elapsed_s())
        return slot

    def _release_slot(self, slot: StreamSlot) -> None:
        tenant = slot.tenant or DEFAULT_TENANT
        self.pool.release(slot)
        self.admission.release()
        self.tel.tenant_active.labels(tenant=tenant).dec()

    def begin_drain(self) -> None:
        """Stop admitting completions (SIGTERM): waiting and new requests get
        503 + Retry-After, ``/readyz`` flips 503, in-flight requests finish.
        Idempotent."""
        self.draining = True
        self.admission.begin_drain()
        self.tel.draining.set(1)

    def drain_wait(self, timeout_s: float) -> bool:
        """Wait until every permit is back (no completion in flight), at
        most ``timeout_s``; True if idle."""
        return self.admission.drain_wait(timeout_s)

    def close(self) -> None:
        """Stop the pool's supervision and close every replica's scheduler
        (its watchdog thread, its slab and pool): the server is shut down."""
        self.pool.close()

    def note_deadline_exceeded(self) -> None:
        with self._count_lock:
            self.deadline_exceeded_total += 1
        self.tel.deadline_exceeded.inc()

    def retry_after(self) -> int:
        """Seconds for a 429/503 ``Retry-After``: base plus uniform jitter,
        drawn per response."""
        return self.retry_after_base_s + self._retry_rng.randint(0, self.retry_after_jitter_s)

    def ready_payload(self) -> dict:
        """The ``/readyz`` JSON body: drain status, queue depth, free lanes
        (clamped: mid-failover the permit count is transiently negative) and
        every replica's snapshot (state, active rows, lanes, restarts,
        prefix-cache occupancy)."""
        return {
            "status": "draining" if self.draining else "ready",
            "draining": self.draining,
            "queue_depth": self.admission.waiting(),
            "free_slots": max(0, self.admission.free_slots()),
            "weights_version": self.pool.weights_version,
            "rollout": self.pool.rollout_status(),
            "replicas": self.pool.snapshot(),
        }

    def _canary_probe(self, rep, messages=None, tenant=None):
        """One integrity probe on replica ``rep``: the pinned greedy prompt
        (or ``messages``, a shadow vote) through its real batched decode on a
        directly claimed lane, prefix cache off (the probe must read this
        replica's weights, not shared pages), priority below every class.
        Returns ``(tokens, fingerprint)``, or None when inconclusive: every
        lane busy, the probe preempted, past a deadline or quarantined, or
        the replica lost. ``tenant`` is the reserved billing identity
        (default the canary's; rollout certification uses ``_rollout``)."""
        tenant = tenant or integrity.CANARY_TENANT
        slot = self.pool.claim_slot(rep.idx, tenant=tenant)
        if slot is None:
            return None
        stream = slot.stream
        try:
            stream.reset()
            slot.cache.clear()
            stream.prefix_cache_enabled = False
            stream.tenant = tenant
            stream.priority = CANARY_PRIORITY
            msgs = messages or [{"role": "user", "content": self.canary_prompt}]
            toks = self.tokenizer.encode(
                self.template.generate([ChatItem(m["role"], m["content"]) for m in msgs],
                                       append_generation_prompt=True), add_bos=True)
            budget = stream.cfg.seq_len - len(toks) - 1
            if budget < 1:
                return None  # the probe prompt does not fit this context
            n = max(1, min(self.canary_tokens, budget))
            first_dev = stream.prefill_device(toks, 0.0, self.args.topp, 0)
            out: list[int] = []

            def on_token(prev: int, t: int) -> bool:
                out.append(int(t))
                return len(out) < n

            stream.stream_decode(first_dev, on_token, 0.0, self.args.topp, seed=0, first_prev=toks[-1],
                                 limit=len(toks) + n)
            if not out:
                return None
            # the fold of exactly the chunks behind the decoded tokens (the
            # fused first token precedes them); an independent EngineStream
            # has no fingerprints and compares tokens only
            fp = stream.run_fingerprint(len(out) - 1) if hasattr(stream, "run_fingerprint") else None
            return tuple(out), fp
        except (faults.RowPreempted, faults.ReplicaLost, DeadlineExceeded, faults.RowQuarantined):
            # yielded to real work, died, or failed loudly (the quarantine
            # owns that): inconclusive this time
            return None
        finally:
            try:
                stream.reset()
            except Exception:
                pass
            slot.cache.clear()
            stream.prefix_cache_enabled = True
            stream.tenant = None
            stream.priority = None
            self.pool.release(slot)

    def _maybe_shadow(self, params: dict) -> None:
        """Shadow voting (``--sdc-shadow-rate``): a sampled share of
        completed greedy requests re-runs on two live replicas on a daemon
        thread (the client never waits for the vote); a divergence turns
        both suspect and the canary resolves which is corrupt."""
        if (self.shadow_rate <= 0.0 or params["temperature"] != 0.0 or len(self.pool.replicas) < 2
                or self._shadow_rng.random() >= self.shadow_rate):
            return
        if not self._shadow_gate.acquire(blocking=False):
            return  # a vote is in flight: this sample is dropped

        def vote():
            try:
                self.pool.shadow_vote(self._canary_probe, params["messages"])
            finally:
                self._shadow_gate.release()

        threading.Thread(target=vote, name="dllama-sdc-shadow", daemon=True).start()

    def complete(self, body: dict, send_chunk, params: dict | None = None,
                 request_id: str | None = None) -> dict | None:
        """Run one completion. ``send_chunk(str)`` streams SSE data lines when
        the request has stream=true (then returns None); otherwise returns
        the response JSON.

        A preempted request, or one whose replica died, re-enters fair
        admission and re-runs from its prompt at the same pinned seed on
        whatever live replica placement picks; the re-run streams what the
        first run streamed, so its first ``sent`` SSE deltas are suppressed
        and the client sees one continuous stream (the replay's trace
        attempt is a sibling in the same tree)."""
        if params is None:
            params = self._parse(body)
        if request_id is None:
            request_id = new_request_id()
        # one monotonic instant for queueing, prefill and decode, across
        # requeues too
        deadline_ms = params.get("deadline_ms") or self.default_deadline_ms
        deadline = time.monotonic() + float(deadline_ms) / 1000.0 if deadline_ms else None
        # canonical once: past the registry cap, unknown names fold into the
        # default bucket before any per-tenant label is minted
        tenant = self.admission.resolve(params.get("tenant") or DEFAULT_TENANT)
        priority = params.get("priority")
        if priority is None:
            priority = self.admission.config(tenant).priority
        if self.draining:
            raise ServerDraining("server is draining; not admitting")
        # the seed is pinned once per request, not per attempt: a replay
        # must draw the coins the first run drew
        if params.get("seed") is None:
            params["seed"] = int(time.time_ns() % (1 << 31))
        traces = self.traces
        ctx = traces.begin(request_id, tenant) if traces is not None else None
        attempts = sent = skip = 0

        def guarded_send(data: str):
            nonlocal sent, skip
            if skip > 0:
                skip -= 1  # a delta the client already has
                return
            send_chunk(data)
            sent += 1

        route_tokens = self._route_tokens(params)

        def attempt_once():
            nonlocal attempts, skip
            skip = sent
            if ctx is not None:
                ctx.begin_attempt(replayed=attempts > 0)
            attempts += 1
            slot = self._acquire_slot(params["messages"], deadline, tenant, priority, route_tokens, ctx=ctx)
            # the lane's own scheduler (its replica's): request-end
            # bookkeeping lands where the row was served
            sched = getattr(slot.stream, "scheduler", None)
            if ctx is not None:
                ctx.set_replica(sched.replica_id if sched is not None else 0)
            try:
                slot.stream.deadline = deadline
                slot.stream.prefix_cache_enabled = params.get("cache", "on") != "off"
                # the row's labels for preempt_below's victim choice
                slot.stream.tenant = tenant
                slot.stream.priority = priority
                # the batch scheduler records this row's spans into the trace
                slot.stream.trace = ctx
                return self._complete_on(slot, params, guarded_send, request_id, deadline, ctx)
            finally:
                slot.stream.deadline = None
                slot.stream.prefix_cache_enabled = True
                slot.stream.tenant = None
                slot.stream.priority = None
                slot.stream.trace = None
                if sched is not None:
                    # an eviction the request beat to the finish line must
                    # not requeue the row's next request
                    sched.retract_preemption(slot.stream)
                self._release_slot(slot)

        def on_requeue(attempt: int, e: Exception) -> None:
            if isinstance(e, faults.ReplicaCorrupt) and sent > 0:
                # the replica died of silent corruption after this stream
                # sent deltas, which may be wrong themselves: a suppressed
                # replay would splice them onto a right continuation, so the
                # request ends typed (raising here ends the requeue loop)
                raise e
            if isinstance(e, NoPlaceableReplica):
                return  # a placement bounce: nothing ran, so nothing replays
            if isinstance(e, faults.ReplicaLost):
                # a failover replay onto a surviving replica, counted under
                # the pool's lock (a failover's victims requeue at once)
                self.pool.count_replay()
                self.tel.replayed_requests.inc()
            else:
                self.tel.preempt_requeues.inc()

        try:
            result = retry.retry_call(attempt_once, REQUEUE_POLICY,
                                      retry_on=(faults.RowPreempted, faults.ReplicaLost), on_retry=on_requeue)
        finally:
            if ctx is not None:
                # TTFT/TPOT and the stage breakdown observe the timestamps
                # the trace tree reports, so /metrics and /debug/trace agree;
                # a failed request still attributes where its time went
                if ctx.ttft_s is not None:
                    self.tel.ttft.labels(tenant=tenant).observe(ctx.ttft_s)
                if ctx.tpot_s is not None:
                    self.tel.tpot.labels(tenant=tenant).observe(ctx.tpot_s)
                for stage, seconds in dict(ctx.stages).items():
                    self.tel.stage_seconds.labels(stage=stage, tenant=tenant).observe(seconds)
                traces.finish(ctx)
        # shadow votes sample completed greedy requests, off the request path
        self._maybe_shadow(params)
        return result

    def _complete_on(self, slot: StreamSlot, params: dict, send_chunk, request_id: str,
                     deadline: float | None = None, ctx=None) -> dict | None:
        engine, tokenizer = slot.stream, self.tokenizer
        stream = params["stream"]
        # stage clock: prefill = entry to the prefill's return (tokenize,
        # cache resolve, dispatch), decode = the rest of the token loop
        stage_sw = Stopwatch() if ctx is not None else None
        if deadline is not None and time.monotonic() >= deadline:
            raise DeadlineExceeded("deadline expired before prefill")
        start_pos, delta_messages = slot.cache.resolve_delta_prompt(params["messages"])
        engine.rollback(min(start_pos, engine.pos))
        if engine.pos != start_pos:  # the cache would resume further than the stream's state
            engine.reset()
            slot.cache.clear()
            start_pos = 0
            delta_messages = params["messages"]
        items = [ChatItem(m["role"], m["content"]) for m in delta_messages]
        prompt_tokens = tokenizer.encode(self.template.generate(items, append_generation_prompt=True), add_bos=True)
        seq_len = engine.cfg.seq_len
        budget = seq_len - engine.pos
        warning = None
        if len(prompt_tokens) > budget:
            warning = f"prompt truncated: {len(prompt_tokens)} tokens > {budget} remaining context (seq_len {seq_len})"
            print(f"⚠️ {warning}")
            prompt_tokens = prompt_tokens[:budget]
        prompt_end = start_pos + len(prompt_tokens)
        for m in delta_messages:
            slot.cache.push(prompt_end, m["role"], m["content"])

        max_pos = prompt_end + params["max_tokens"] if params["max_tokens"] > 0 else seq_len
        max_pos = min(max_pos, seq_len)
        max_new = max_pos - prompt_end  # the completion budget in emitted tokens
        topp, topk, seed = params["topp"], params["topk"], params["seed"]
        slot.sampler.temperature = params["temperature"]
        slot.sampler.topp = topp
        slot.sampler.topk = topk
        slot.sampler.set_seed(seed)

        device_decode = getattr(self.args, "decode", "device") == "device" and max_new > 0
        with trace.span(ctx, "prefill", tokens=len(prompt_tokens), start_pos=start_pos, fused=device_decode):
            if device_decode:
                # the first token is sampled on the device; its host copy
                # starts here and is fetched before decode chunk 1 is issued
                first_dev = engine.prefill_device(prompt_tokens, params["temperature"], topp, seed, topk)
            else:
                logits = engine.prefill(prompt_tokens)
        if ctx is not None:
            ctx.add_stage("prefill", stage_sw.elapsed_s())
            stage_sw.restart()

        stops = self.stops + params["stop"]
        max_stop = max(len(s) for s in stops) if stops else 0
        detector = EosDetector({tokenizer.chat_eos_id}, stops, padding_left=max_stop, padding_right=max_stop)
        buffer: list[str] = []
        emitted = 0
        finish_reason = "length"

        def feed(prev: int, token: int) -> int:
            nonlocal emitted
            if deadline is not None and time.monotonic() >= deadline:
                # per-token deadline (both decode paths; the batch scheduler
                # also retires the row between chunks)
                raise DeadlineExceeded(f"deadline expired after {emitted} tokens")
            emitted += 1
            piece = tokenizer.decode_piece(prev, token)
            res = detector.append(token, piece if is_safe_piece(piece) else b"")
            if res in (EosDetectorResult.NOT_EOS, EosDetectorResult.EOS):
                delta = detector.get_delta()
                if delta:
                    text = delta.decode("utf-8", errors="replace")
                    buffer.append(text)
                    if stream:
                        with trace.span(ctx, "sse_send", chars=len(text)):
                            send_chunk(self._chunk_json(text, stop=False, request_id=request_id))
                detector.clear()
            if ctx is not None:
                # the TTFT/TPOT stamp, after this token's delta (if any) is
                # written: the first stamp is the time to first token
                ctx.mark_token()
            return res

        decode_t0 = time.perf_counter()
        try:
            if device_decode:
                if max_new == 1:
                    # a one-token completion fetches the first token directly
                    if feed(prompt_tokens[-1], engine.fetch_first_token(first_dev)) == EosDetectorResult.EOS:
                        finish_reason = "stop"
                else:
                    def on_token(prev: int, t: int) -> bool:
                        nonlocal finish_reason
                        if feed(prev, t) == EosDetectorResult.EOS:
                            finish_reason = "stop"
                            return False
                        return emitted < max_new

                    # --spec-draft k: prompt-lookup drafts over this request's
                    # prompt and output, verified k at a time in one weight read
                    engine.stream_decode(first_dev, on_token, params["temperature"], topp, seed=seed,
                                         chunk=getattr(self.args, "decode_chunk", 32), limit=max_pos,
                                         first_prev=prompt_tokens[-1],
                                         spec_draft=getattr(self.args, "spec_draft", 0),
                                         spec_ngram=getattr(self.args, "spec_ngram", 3),
                                         prompt_tokens=prompt_tokens, topk=topk)
            elif max_new > 0:
                # --decode host: each token samples on the host from fetched
                # logits; the counter sampler replays the device stream
                token = slot.sampler.sample(logits, pos=engine.pos - 1)
                res = feed(prompt_tokens[-1], token)
                while res != EosDetectorResult.EOS and emitted < max_new and engine.pos < seq_len:
                    prev = token
                    token = slot.sampler.sample(engine.decode_step(prev), pos=engine.pos - 1)
                    res = feed(prev, token)
                if res == EosDetectorResult.EOS:
                    finish_reason = "stop"
        finally:
            if ctx is not None:
                # the whole token loop as one span; the scheduler fans per-row
                # children of the shared steps into the same tree
                ctx.add_span("decode_stream", decode_t0, time.perf_counter() - decode_t0, emitted=emitted,
                             finish=finish_reason)
                ctx.add_stage("decode", stage_sw.elapsed_s())
        if finish_reason == "length":
            # flush text held back as a possible stop-string prefix
            tail = detector.flush_delta()
            if tail:
                text = tail.decode("utf-8", errors="replace")
                buffer.append(text)
                if stream:
                    send_chunk(self._chunk_json(text, stop=False, request_id=request_id))

        content = "".join(buffer)
        if engine.pos >= seq_len:
            slot.cache.clear()
        else:
            slot.cache.push(engine.pos, "assistant", content)
        if stream:
            send_chunk(self._chunk_json("", stop=True, finish_reason=finish_reason, warning=warning,
                                        request_id=request_id))
            send_chunk("[DONE]")
            return None
        result = {
            "id": f"chatcmpl-{request_id}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": MODEL_NAME,
            "usage": {
                "prompt_tokens": len(prompt_tokens),
                "completion_tokens": emitted,
                "total_tokens": len(prompt_tokens) + emitted,
            },
            "choices": [{"index": 0, "message": {"role": "assistant", "content": content},
                         "finish_reason": finish_reason}],
        }
        if warning is not None:
            result["warning"] = warning
        return result

    def _chunk_json(self, delta_text: str, stop: bool, finish_reason: str = "stop", warning: str | None = None,
                    request_id: str = "0") -> str:
        choice: dict = {"index": 0, "finish_reason": finish_reason if stop else ""}
        choice["delta"] = {"role": "", "content": ""} if stop else {"role": "assistant", "content": delta_text}
        payload = {"id": f"chatcmpl-{request_id}", "object": "chat.completion", "created": int(time.time()),
                   "model": MODEL_NAME, "choices": [choice]}
        if warning is not None:
            payload["warning"] = warning
        return json.dumps(payload)

    def _parse(self, body: dict) -> dict:
        """Validate and normalize a request body; raises :class:`BadRequest`."""
        if not isinstance(body, dict):
            raise BadRequest("request body must be a JSON object")
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise BadRequest("'messages' must be a non-empty array")
        for i, m in enumerate(messages):
            if not isinstance(m, dict) or not isinstance(m.get("role"), str) or not isinstance(m.get("content"), str):
                raise BadRequest(f"messages[{i}] must be an object with string 'role' and 'content'")
        stop = body.get("stop", ["<|eot_id|>"])
        if stop is None:
            stop = []
        elif isinstance(stop, str):
            stop = [stop]
        if not isinstance(stop, list) or not all(isinstance(s, str) for s in stop):
            raise BadRequest("'stop' must be a string, an array of strings, or null")
        try:
            temperature = float(body.get("temperature", self.args.temperature))
            topp = float(body.get("top_p", self.args.topp))
            topk = int(body.get("top_k", getattr(self.args, "topk", 0) or 0))
            max_tokens = int(body.get("max_tokens", -1))
            seed = body.get("seed")
            if seed is not None:
                seed = int(seed)
            deadline_ms = body.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)
            priority = body.get("priority")
            if priority is not None:
                priority = int(priority)
        except (TypeError, ValueError) as e:
            raise BadRequest(f"invalid numeric field: {e}") from None
        # tenant names feed the fair admission queues; a leading underscore
        # is reserved for internal tenants (integrity.RESERVED_TENANTS: the
        # canary's and rollout certification's), which a client must not
        # impersonate
        tenant = body.get("tenant", DEFAULT_TENANT)
        if not isinstance(tenant, str) or not tenant or len(tenant) > 64 or tenant.startswith("_"):
            raise BadRequest("'tenant' must be a non-empty string of at most 64 chars not starting with '_' "
                             "(reserved)")
        if deadline_ms is not None and not (math.isfinite(deadline_ms) and deadline_ms > 0):
            # NaN would poison every monotonic comparison
            raise BadRequest("'deadline_ms' must be a positive finite number of ms")
        cache = body.get("cache", "on")
        if cache not in ("on", "off"):
            raise BadRequest("'cache' must be \"on\" or \"off\"")
        if not (0.0 <= topp <= 1.0) or not math.isfinite(topp):
            raise BadRequest("'top_p' must be a number in [0, 1]")
        if topk < 0:
            raise BadRequest("'top_k' must be a non-negative integer (0 = off)")
        return {
            "cache": cache,
            "messages": [{"role": m["role"], "content": m["content"]} for m in messages],
            "stream": bool(body.get("stream", False)),
            "temperature": temperature,
            "topp": topp,
            "topk": topk,
            "seed": seed,
            "max_tokens": max_tokens,
            "stop": [s for s in stop if s],
            "deadline_ms": deadline_ms,
            "tenant": tenant,
            "priority": priority,
        }


def make_handler(state: ApiState):
    tel = state.tel

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):
            print(f"🔷 {self.command} {self.path}")

        def _send_json(self, status: int, payload: dict, request_id: str | None = None,
                       extra_headers: dict | None = None) -> None:
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            if request_id is not None:
                self.send_header("X-Request-Id", request_id)
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _error(self, status: int, message: str, err_type: str, rid: str, extra_headers=None) -> None:
            body = {"error": {"message": message, "type": err_type, "request_id": rid}}
            self._send_json(status, body, request_id=rid, extra_headers=extra_headers)

        def do_GET(self):
            route, status = self._do_get_inner()
            tel.requests.labels(route=route, status=str(status)).inc()

        def _do_get_inner(self) -> tuple[str, int]:
            """Serve one GET; returns (route, status) for the request counter."""
            if self.path == "/v1/models":
                self._send_json(200, {"object": "list",
                                      "data": [{"id": "dl", "object": "model", "created": 0, "owned_by": "user"}]})
                return "/v1/models", 200
            if self.path == "/healthz":
                # liveness: the HTTP loop and its handler threads are alive
                self._send_json(200, {"status": "ok"})
                return "/healthz", 200
            if self.path == "/readyz":
                # readiness: admitting new work; 503 while draining, so load
                # balancers stop routing here while in-flight requests finish
                code = 503 if state.draining else 200
                self._send_json(code, state.ready_payload())
                return "/readyz", code
            if self.path.rstrip("/") == "/debug/flight":
                # the flight recorder: every replica's lifecycle ring and
                # the retained dumps
                self._send_json(200, flight.RECORDER.snapshot())
                return "/debug/flight", 200
            if self.path == "/metrics":
                # the process registry; valid (possibly empty) exposition
                # with telemetry off, so scrapers never see a 404
                payload = telemetry.prometheus_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return "/metrics", 200
            if self.path.startswith("/debug/trace/"):
                # one request's span tree: JSON, or ?format=chrome for
                # chrome://tracing / ui.perfetto.dev; a 404 carries the
                # store's stats (not sampled, never started, rotated out)
                req_id, _, query = self.path[len("/debug/trace/"):].partition("?")
                traces = state.traces
                ctx = traces.get(req_id) if traces is not None else None
                if ctx is None:
                    self._send_json(404, {"error": "trace not found", "request_id": req_id,
                                          "tracing_enabled": traces is not None,
                                          "store": traces.stats() if traces else None})
                    return "/debug/trace", 404
                self._send_json(200, ctx.chrome_trace() if "format=chrome" in query else ctx.tree())
                return "/debug/trace", 200
            self.send_error(404)
            return "other", 404

        def do_POST(self):
            # monotonic request duration; every response carries a request id
            rid = new_request_id()
            sw = Stopwatch()
            status = 500
            tel.inflight.inc()
            try:
                status = self._do_post_inner(rid)
            finally:
                route = "/v1/chat/completions" if self.path == "/v1/chat/completions" else "other"
                tel.requests.labels(route=route, status=str(status)).inc()
                tel.request_duration.observe(sw.elapsed_s())
                # last: an in-flight gauge at 0 means every finished request
                # is counted (the load generator waits for it to scrape)
                tel.inflight.dec()

        def _admin_rollout(self, rid: str) -> int:
            """``POST /admin/rollout``: a blue-green weight rollout, run
            synchronously on this handler thread while sibling threads keep
            serving. Body ``{"version": "v1"[, "weights": path][,
            "checksum": ref]}``: ``weights`` registers the version from a
            file first. 200 with the summary, 409 on a conflict (nothing
            started), 500 aborted and rolled back (with the rollout's
            state)."""
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                length = 0
            try:
                body = json.loads(self.rfile.read(max(length, 0)) or b"{}")
            except json.JSONDecodeError as e:
                self._error(400, f"malformed JSON: {e}", "invalid_request_error", rid)
                return 400
            if not isinstance(body, dict):
                body = {}
            version = body.get("version")
            if not isinstance(version, str) or not version:
                self._error(400, "'version' must be a non-empty string", "invalid_request_error", rid)
                return 400
            try:
                if body.get("weights"):
                    state.register_weights_path(version, body["weights"])
                result = state.rollout.run(version, checksum=body.get("checksum"))
            except fleet.RolloutConflict as e:
                self._error(409, str(e), "rollout_conflict", rid)
                return 409
            except fleet.RolloutAborted as e:
                payload = {"error": {"message": str(e), "type": "rollout_aborted", "request_id": rid},
                           "rollout": state.pool.rollout_status()}
                self._send_json(500, payload, request_id=rid)
                return 500
            except Exception as e:
                self._error(500, f"{type(e).__name__}: {e}", "server_error", rid)
                return 500
            self._send_json(200, result, request_id=rid)
            return 200

        def _do_post_inner(self, rid: str) -> int:
            """Handle one POST; returns the response status for the counter
            (499: the client went away mid-stream)."""
            if self.path == "/admin/rollout":
                return self._admin_rollout(rid)
            if self.path != "/v1/chat/completions":
                self.send_error(404)
                return 404
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self._error(400, "invalid Content-Length", "invalid_request_error", rid)
                self.close_connection = True
                return 400
            if length > state.max_body_bytes:
                # reject without reading; the unread body makes the connection unusable
                self._error(413, f"request body {length} bytes exceeds the {state.max_body_bytes}-byte limit",
                            "request_too_large", rid)
                self.close_connection = True
                return 413
            try:
                body = json.loads(self.rfile.read(max(length, 0)) or b"{}")
                params = state._parse(body)
            except json.JSONDecodeError as e:
                self._error(400, f"malformed JSON: {e}", "invalid_request_error", rid)
                return 400
            except BadRequest as e:
                self._error(400, str(e), "invalid_request_error", rid)
                return 400
            # SSE headers go out with the first event, so a request rejected
            # before any token still gets a clean HTTP status
            sse_started = False

            def send_chunk(data: str):
                nonlocal sse_started
                state.faults.fire("server.send")
                if not sse_started:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Connection", "close")
                    self.send_header("X-Request-Id", rid)
                    self.end_headers()
                    sse_started = True
                self.wfile.write(f"data: {data}\r\n\r\n".encode())
                self.wfile.flush()

            def sse_error(message: str, err_type: str) -> None:
                # a failure after the stream started: a terminal error event,
                # so the client sees it instead of a silent truncation
                try:
                    err = json.dumps({"error": {"message": message, "type": err_type, "request_id": rid}})
                    self.wfile.write(f"data: {err}\r\n\r\ndata: [DONE]\r\n\r\n".encode())
                    self.wfile.flush()
                except OSError:
                    pass
                self.close_connection = True

            def fail(status: int, e: BaseException, err_type: str, retry_after: bool = False) -> int:
                if sse_started:
                    sse_error(str(e), err_type)
                else:
                    headers = {"Retry-After": str(state.retry_after())} if retry_after else None
                    self._error(status, str(e), err_type, rid, extra_headers=headers)
                return status

            try:
                if params["stream"]:
                    state.complete(body, send_chunk, params=params, request_id=rid)
                    self.close_connection = True
                else:
                    self._send_json(200, state.complete(body, lambda s: None, params=params, request_id=rid),
                                    request_id=rid)
                return 200
            except BrokenPipeError:
                self.close_connection = True  # the client went away mid-stream
                return 499
            # a preemption requeue re-enters admission mid-stream, so a full
            # queue or a drain can also surface after deltas went out
            except AdmissionRejected as e:
                return fail(429, e, "overloaded", retry_after=True)
            except ServerDraining as e:
                return fail(503, e, "draining", retry_after=True)
            except (faults.RowPreempted, faults.ReplicaLost) as e:
                # preempted (or orphaned by dying replicas)
                # MAX_PREEMPT_REQUEUES times in a row: shed it like overload
                # rather than spin a handler thread forever; a corrupt loss
                # after deltas went out was not replayed (the client starts
                # afresh)
                if isinstance(e, faults.ReplicaCorrupt):
                    kind = "replica_corrupt"
                elif isinstance(e, faults.ReplicaLost):
                    kind = "replica_lost"
                else:
                    kind = "preempted"
                return fail(503, e, kind, retry_after=True)
            except DeadlineExceeded as e:
                state.note_deadline_exceeded()
                return fail(504, e, "deadline_exceeded")
            except Exception as e:  # an engine failure (quarantine, stall): surface it, keep serving
                print(f"🛑 request {rid} failed: {type(e).__name__}: {e}")
                return fail(500, e, "server_error")

    return Handler


def make_server(args, state: ApiState | None = None) -> tuple[ThreadingHTTPServer, ApiState]:
    """Build the engine (unless ``state`` is given) and a threaded HTTP
    server on ``args.host:args.port`` (port 0 picks a free one)."""
    if state is None and getattr(args, "pod", None):
        from distributed_llama_tpu_torch.apps.cli import make_pod_group

        # one-process pod: the group is the engine factory (a replica build
        # or rebuild is a fresh slice over the shared params) and the
        # replica count is the pod's data extent
        group, tokenizer, sampler = make_pod_group(args)
        wanted = getattr(args, "replicas", None)
        if wanted == 1:
            # the consolidated pod: one replica, every lane in one scheduler
            args.replicas = 1
        else:
            if wanted not in (None, group.data):
                print(f"⚠️ --replicas {wanted} ignored under --pod: one replica per data slice ({group.data}), "
                      "or 1 for the consolidated single-domain pod")
            args.replicas = group.data
        state = ApiState(group.slice_engine(), tokenizer, sampler, args, engine_factory=group)
        # POST /admin/rollout's "weights": a second tree over the same
        # backend (the loader holds no params, so a retired tree is freed)
        state.make_engine_for_path = group.loader()
    elif state is None:
        from distributed_llama_tpu_torch.apps.cli import make_engine

        engine, tokenizer, sampler = make_engine(args)

        def engine_factory():
            # replica (re)builds: a fresh engine from the same flags, off
            # the serving path
            return make_engine(args)[0]

        state = ApiState(engine, tokenizer, sampler, args, engine_factory=engine_factory)

        def factory_for_path(path):
            # POST /admin/rollout's "weights": the same flags over another file
            a = copy.copy(args)
            a.model = path
            return lambda: make_engine(a)[0]

        state.make_engine_for_path = factory_for_path
    server = ThreadingHTTPServer((getattr(args, "host", "0.0.0.0"), args.port), make_handler(state))
    server.daemon_threads = True
    return server, state


def drain_then_shutdown(state: ApiState, server, timeout_s: float) -> None:
    """Wait for every in-flight completion to finish, at most ``timeout_s``,
    then stop the HTTP server. Runs on its own thread, so the SIGTERM
    handler returns at once."""
    state.drain_wait(timeout_s)
    server.shutdown()
    state.close()


def install_sigterm_drain(state: ApiState, server, timeout_s: float = 30.0):
    """SIGTERM -> graceful drain: ``/readyz`` flips 503, new completions get
    503, in-flight ones finish, then the server shuts down. Returns the
    handler (tests invoke it directly). Installs nothing off the main thread
    (signal.signal's constraint): an embedded server's caller drains."""

    def handler(signum, frame):
        state.begin_drain()
        threading.Thread(target=drain_then_shutdown, args=(state, server, timeout_s), name="dllama-drain",
                         daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, handler)
    except ValueError:
        pass  # not the main thread
    return handler


def serve(args) -> None:
    # before the engine and ApiState bind their instruments and fault plan
    # (bind-once)
    if getattr(args, "telemetry", False):
        telemetry.enable()
    spec = getattr(args, "faults", None)
    if spec:
        faults.install(faults.parse(spec, seed=getattr(args, "faults_seed", 0)))
        print(f"⚠️ fault plan active: {spec}")
    server, state = make_server(args)
    install_sigterm_drain(state, server, timeout_s=getattr(args, "drain_timeout_s", 30.0))
    print(f"Server URL: http://127.0.0.1:{server.server_address[1]}/v1/")
    if telemetry.is_enabled():
        print(f"Metrics:    http://127.0.0.1:{server.server_address[1]}/metrics")
    server.serve_forever()


def build_parser() -> argparse.ArgumentParser:
    from distributed_llama_tpu_torch.apps.cli import build_parser as cli_parser

    p = cli_parser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9990)
    p.add_argument("--parallel", type=int, default=2, help="concurrent in-flight completions per replica")
    p.add_argument("--replicas", type=int, default=None,
                   help="supervised data-parallel replicas behind one admission front door, each its own engine "
                   "and batch scheduler (total lanes = replicas x --parallel; default 1, or one per data slice "
                   "under --pod, where an explicit 1 picks the consolidated single-domain pod). A dead replica's "
                   "in-flight requests replay bit-identically on survivors while the supervisor restarts it with "
                   "jittered backoff; /readyz reports each replica's state")
    p.add_argument("--replica-suspect-s", type=float, default=30.0,
                   help="dispatch round-trip duration past which a replica turns SUSPECT (skipped for new "
                   "placements until a fast round trip clears it)")
    p.add_argument("--replica-restart-backoff-s", type=float, default=0.5,
                   help="base restart backoff for a dead replica (exponential to 30 s, entropy-jittered)")
    p.add_argument("--sdc-canary-interval-s", type=float, default=0.0,
                   help="period of the per-replica SDC canary: a pinned greedy prompt through each replica's real "
                   "batched path on a reserved lane, compared (tokens + logit fingerprint) against its weight "
                   "version's golden; consecutive mismatches walk the replica healthy -> suspect -> dead as "
                   "corrupt and its rebuild must pass the weight checksum. 0 disables the background canary")
    p.add_argument("--sdc-canary-tokens", type=int, default=12,
                   help="greedy tokens per canary probe (longer = more sensitive to deep-layer corruption, costlier)")
    p.add_argument("--sdc-canary-threshold", type=int, default=2,
                   help="consecutive canary mismatches before the replica is declared corrupt-dead (1 = the first "
                   "mismatch kills; the default 2 walks suspect first)")
    p.add_argument("--sdc-shadow-rate", type=float, default=0.0,
                   help="fraction of completed greedy requests re-executed on two live replicas off the request "
                   "path and compared: a divergence marks both suspect and the canary resolves which is corrupt. "
                   "0 disables")
    p.add_argument("--weights-version", type=str, default=None,
                   help="version id of the boot weights (default v0): the key of the pool's checksum reference and "
                   "canary golden, and what /readyz reports; POST /admin/rollout moves the pool to another one")
    p.add_argument("--rollout-drain-s", type=float, default=15.0,
                   help="per-replica drain cap during a rollout move; past it the lingering requests fail over "
                   "(replayed on a survivor) and the supervisor rebuilds the replica on the new version")
    p.add_argument("--fleet-min-replicas", type=int, default=1,
                   help="elasticity floor: the fleet controller never shrinks the pool below this many replicas")
    p.add_argument("--fleet-max-replicas", type=int, default=None,
                   help="elasticity ceiling: sustained admission-queue pressure grows the pool up to this many "
                   "replicas (each a full engine build behind the checksum gate). Default: the boot replica "
                   "count, i.e. no growth")
    p.add_argument("--fleet-interval-s", type=float, default=0.0,
                   help="fleet controller tick period; each tick reads the admission queue depth and new 429s and, "
                   "after consecutive-tick hysteresis, grows or drains and retires one replica. 0 disables the "
                   "background loop")
    p.add_argument("--fleet-queue-high", type=int, default=None,
                   help="queued demand that counts as scale-up pressure (default: one replica's lanes)")
    p.add_argument("--batch-decode", action=argparse.BooleanOptionalAction, default=True,
                   help="coalesce concurrent completions into one batched decode dispatch per chunk "
                   "(--decode device, --parallel > 1)")
    p.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction, default=True,
                   help="reuse published KV pages for repeated prompt prefixes (batched serving); "
                   "requests opt out with the body field 'cache': \"off\"")
    p.add_argument("--kv-pages", type=int, default=None,
                   help="page-pool budget in pages (default --parallel x ceil(seq_len/page) plus 25%%; "
                   "0 disables the prefix cache)")
    p.add_argument("--kv-page-size", type=int, default=64, help="positions per KV page")
    p.add_argument("--host-spill-mb", type=float, default=64.0,
                   help="host-RAM budget (MiB) of the prefix-page spill arena: evicted KV pages spill here (bytes "
                   "verbatim, CRC-guarded) and re-upload on a later match instead of re-prefilling; shared across "
                   "replicas. 0 disables the tier. Each page move pays a host CRC under the scheduler lock: at 7B "
                   "bf16 (32 MiB pages) a reloaded prefix answers slower than a cold prefill (PERF.md; ROADMAP "
                   "Queue 1 item 2)")
    p.add_argument("--spill-disk-dir", type=str, default=None,
                   help="directory of the optional mmap'd disk tier below the host-RAM arena: its LRU overflow "
                   "demotes to a fixed-slot spill file instead of being dropped. Off by default")
    p.add_argument("--spill-disk-mb", type=float, default=256.0, help="disk-tier budget (MiB) for --spill-disk-dir")
    p.add_argument("--prefill-chunk", type=int, default=256,
                   help="tokens per prefill dispatch in batched serving (0 = the whole prompt at once)")
    p.add_argument("--admission-queue", type=int, default=None,
                   help="requests that may wait for a lane before 429 (default 2 x --parallel)")
    p.add_argument("--max-body-bytes", type=int, default=MAX_BODY_BYTES,
                   help="request-body size cap; a larger Content-Length gets 413 without reading the body "
                   "(default 1 MiB)")
    p.add_argument("--tenants", type=str, default=None,
                   help="tenant admission contracts: ';'-separated 'name:weight=W,priority=P,queue=Q' entries, "
                   "e.g. 'gold:weight=4,priority=10;free:weight=1'. Weights set DRR admission shares under "
                   "saturation; priority sets the default class of the tenant's requests (bodies may override "
                   "with a 'priority' field). Unknown tenants auto-register at weight 1, priority 0")
    p.add_argument("--preempt", action=argparse.BooleanOptionalAction, default=True,
                   help="allow a queued higher-priority request to evict the lowest-priority batched decode row "
                   "to a clean requeue (the victim re-runs through the prefix cache; batched serving only). "
                   "--no-preempt queues strictly")
    p.add_argument("--retry-after-jitter-s", type=int, default=2,
                   help="max uniform jitter added to the 1 s Retry-After base on 429/503 responses, drawn per "
                   "response (0 restores the fixed value)")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="default per-request deadline in ms (requests may set their own 'deadline_ms'); an "
                   "expired request ends 504 / an SSE error event and its batch row leaves the shared dispatch")
    p.add_argument("--stall-timeout-s", type=float, default=120.0,
                   help="batched-decode watchdog: a chunk fetch in flight longer than this fails its rows "
                   "cleanly instead of hanging every lane (0 disables)")
    p.add_argument("--faults", type=str, default=None,
                   help="fault-plan spec (or the DLLAMA_FAULTS env), e.g. 'batch.fetch:kind=raise,after=2,count=1': "
                   "';'-separated 'site:kind=K,after=N,count=C,p=P,row=R,delay_ms=D' rules (engine/faults.py)")
    p.add_argument("--faults-seed", type=int, default=0, help="seed for probabilistic fault rules (p<1)")
    p.add_argument("--drain-timeout-s", type=float, default=30.0,
                   help="SIGTERM drain: max seconds to wait for in-flight completions before shutting the "
                   "listener down")
    p.add_argument("--trace-sample-rate", type=float, default=1.0,
                   help="fraction of finished request traces RETAINED for GET /debug/trace/<id> (every request "
                   "records while telemetry is on; sampling decides retention). Slow requests are always kept "
                   "— see --trace-slow-ttft-s. Requires --telemetry")
    p.add_argument("--trace-slow-ttft-s", type=float, default=1.0,
                   help="TTFT threshold (seconds) above which a finished trace is retained regardless of "
                   "--trace-sample-rate; 0 disables the override")
    p.add_argument("--trace-retention", type=int, default=256,
                   help="max finished traces retained (bounded deque; oldest rotate out first)")
    p.add_argument("--flight-dump-dir", type=str, default=None,
                   help="directory for flight-recorder JSON dumps written on each replica death (the ring behind "
                   "GET /debug/flight is always on)")
    return p


def main(argv=None) -> None:
    raw = list(sys.argv[1:] if argv is None else argv)
    if not raw or raw[0] not in ("inference", "generate"):
        raw = ["generate"] + raw  # the shared parser's mode is meaningless here
    serve(build_parser().parse_args(raw))


if __name__ == "__main__":
    main()
