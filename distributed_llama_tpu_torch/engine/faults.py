"""Deterministic fault injection for chaos testing.

The port's copy of the JAX package's ``engine/faults.py``: a process-wide
:class:`FaultPlan` with NAMED injection sites threaded through the engine,
the batch scheduler and the API server, so chaos tests provoke the exact
failure they want — deterministically, from a seed — and assert the system
degrades instead of collapsing.

Injection sites (the strings passed to :meth:`FaultPlan.fire`). The parser
accepts every site name of the JAX package; the port fires these:

==========================  =================================================
``batch.dispatch``          raise inside the batched chunk dispatch
                            (engine/batch.py; retried with backoff before the
                            rows are retired). It fires before any launch.
``batch.fetch``             raise/delay/hang inside the batched chunk fetch
                            (a raise is retried on the same host copy, a hang
                            trips the stall watchdog)
``batch.row``               corrupt ONE row of a fetched chunk (``kind=nan``
                            with a ``row=``); the scheduler quarantines only
                            that row
``engine.forward``          raise at any single-stream forward dispatch
``engine.decode_dispatch``  raise at a single-stream decode-chunk dispatch
``engine.fetch``            raise/delay at the single-stream chunk fetch
``engine.spec_verify``      raise at a speculative verify step: fired at the
                            single-stream verify dispatch, and per row while
                            a batched verify's results are validated (a
                            ``row=`` rule quarantines only that row)
``engine.paged_attn``       raise per joined row while a paged batched chunk
                            is built: a ``row=`` rule quarantines only the
                            victim and releases its page pins
``engine.fused_step``       raise per joined row as a batched chunk is about
                            to launch; a ``row=`` rule quarantines only the
                            victim
``engine.sdc``              ``kind=corrupt`` fired per batched dispatch:
                            ``message=weights`` (the default) perturbs one
                            weight slice in place, ``message=logits`` shifts
                            the next fetched chunk's tokens in-vocab.
                            ``row=`` selects the replica id
``engine.spill``            fired per candidate block while an admission
                            match pulls spilled prefix pages back from the
                            host-RAM arena (engine/spill.py): a raise aborts
                            the reload (blocks already uploaded stay, deeper
                            blocks prefill cold); ``kind=corrupt`` flips the
                            arena entry's bytes in place, which the entry's
                            CRC must catch (the block prefills cold).
                            ``row=`` selects the replica id
``engine.preempt``          raise during a priority preemption's eviction:
                            the victim is quarantined instead of requeued
``replica.crash``           whole-replica loss, fired per batched-chunk and
                            per prefill-chunk dispatch: a raise marks the
                            whole scheduler lost (every in-flight request on
                            it gets a typed ``ReplicaLost``; the server
                            requeues them onto a surviving replica and the
                            supervisor restarts the dead one). ``row=``
                            selects the replica id
``replica.hang``            ``kind=hang`` sleep inside the batched chunk
                            fetch: the stall watchdog trips and, on a
                            supervised replica, escalates the stall to a
                            whole-replica loss. ``row=`` selects the replica
``replica.slow``            ``kind=delay`` inside the batched chunk fetch:
                            the round trip passes the pool's suspect
                            threshold and the replica turns SUSPECT until a
                            fast round trip clears it. ``row=`` selects the
                            replica id
``tp.transfer``             raise/delay inside the tensor-parallel transfer
                            probe (parallel/tensor_parallel.py): the engine
                            keeps its last estimate (0 before the first)
                            instead of failing the request that triggered it;
                            in worker mode every host raises
``server.send``             raise ``BrokenPipeError`` from the SSE chunk
                            writer (``kind=disconnect``)
``server.rollout``          fired once per blue-green rollout move
                            (server/fleet.py; ``row=`` is the replica id):
                            ``kind=corrupt`` perturbs the new engine's
                            weights before the checksum gate, ``raise``
                            fails certification, ``delay``/``hang`` hold
                            the cutover window open
==========================  =================================================

Zero overhead when disabled: components bind ``self._faults =
faults.active_plan()`` at construction and get the shared
:data:`NULL_PLAN` singleton (no-op ``fire``/``fires``) when no plan is
installed. Install a plan BEFORE constructing the engine/scheduler/server.

Configuration: ``DLLAMA_FAULTS="batch.fetch:kind=raise,after=2,count=1"``
(read once at import; ``DLLAMA_FAULTS_SEED`` seeds probabilistic rules), the
server's ``--faults "<spec>"``, or ``faults.install(faults.parse(spec))``.
A spec is ``;``-separated rules, each ``site:key=val,key=val`` (or a JSON
array of rule objects). Fields: ``kind`` (``raise`` | ``nan`` | ``delay`` |
``hang`` | ``disconnect`` | ``corrupt``), ``after`` (skip the first N hits of
the site), ``count`` (fire on this many subsequent hits; -1 = forever),
``p`` (per-hit probability from the seeded RNG), ``row`` (restrict to one
batch row), ``delay_ms`` (for ``delay``/``hang``), ``message``.

Determinism: site-hit counters are lock-protected and count every hook
invocation, so ``after``/``count`` rules fire on the same hits on every run;
``p < 1`` rules draw from one seeded RNG in hit order. Every injection
increments ``dllama_faults_injected_total{site}`` (with telemetry on) and
the plan's plain ``injected_total``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import time

from distributed_llama_tpu_torch import lockcheck


class InjectedFault(RuntimeError):
    """Raised at an injection site by a ``kind=raise`` rule."""


class DeadlineExceeded(RuntimeError):
    """A request ran past its deadline: the row left the batch and the
    stream ends (the API server maps this to 504 / an SSE error event)."""


class RowQuarantined(RuntimeError):
    """This request's batch row was retired after a failed or corrupted
    chunk (bounded retries exhausted); co-batched rows keep streaming."""


class StallTimeout(RuntimeError):
    """The watchdog declared an in-flight batched chunk stalled and failed
    the batch cleanly (the hung fetch's late result is discarded)."""


class RowPreempted(RuntimeError):
    """This request's batch row was evicted by a higher-priority arrival
    (engine/batch.py ``preempt_below``). Not a failure: the serving layer
    requeues the request through weighted-fair admission and replays it at
    its pinned seed, suppressing the SSE deltas already sent."""


class NonFiniteLogits(RowQuarantined):
    """A decode step produced NaN/Inf logits for this row: the device-side
    finiteness flag fetched with every batched chunk, or the host sampler's
    check, caught it before a sampled token could launder it into a
    plausible in-vocab id."""


class ReplicaLost(RuntimeError):
    """This request's whole replica died (a crash at a dispatch, or a stall
    the watchdog escalated). The serving layer requeues the request through
    fair admission onto a surviving replica and replays it at its pinned
    seed, suppressing the SSE deltas already sent."""


class ReplicaCorrupt(ReplicaLost):
    """This request's replica was declared dead for silent data corruption
    (a canary or shadow-vote mismatch): wrong but finite outputs, not a
    crash. Deltas it already sent may be wrong themselves, so a suppressed
    replay would splice a wrong prefix onto a right continuation: the
    server replays such a victim only while nothing has streamed, and
    otherwise ends the stream with a typed ``replica_corrupt`` error."""


KINDS = ("raise", "nan", "delay", "hang", "disconnect", "corrupt")

# the JAX package's registered injection sites, every one accepted by parse
SITES = (
    "batch.dispatch",
    "batch.fetch",
    "batch.row",
    "engine.forward",
    "engine.decode_dispatch",
    "engine.fetch",
    "engine.spec_verify",
    "engine.paged_attn",
    "engine.fused_step",
    "engine.preempt",
    "engine.sdc",
    "engine.spill",
    "replica.crash",
    "replica.hang",
    "replica.slow",
    "tp.transfer",
    "server.send",
    "server.rollout",
)

# a "hang" sleeps this long unless the rule sets delay_ms — far beyond any
# stall timeout, short enough that a daemon-threaded test process still exits
HANG_DEFAULT_MS = 60_000.0

# fire observers: called on every actual injection with (site, rule, row),
# under the plan's lock; a failing observer is swallowed (bookkeeping must
# never alter the injection it observes)
_fire_observers: list = []


def add_fire_observer(fn) -> None:
    if fn not in _fire_observers:
        _fire_observers.append(fn)


def remove_fire_observer(fn) -> None:
    if fn in _fire_observers:
        _fire_observers.remove(fn)


@dataclasses.dataclass
class FaultRule:
    """One injection rule. See the module docstring for field semantics."""

    site: str
    kind: str = "raise"
    after: int = 0
    count: int = 1
    p: float = 1.0
    row: int | None = None
    delay_ms: float = 0.0
    message: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (one of {KINDS})")
        if not self.site:
            raise ValueError("fault rule needs a site")


class FaultPlan:
    """A seeded set of :class:`FaultRule`\\ s plus the per-site hit
    counters that make ``after``/``count``/``p`` deterministic."""

    enabled = True

    def __init__(self, rules, seed: int = 0):
        self.rules: list[FaultRule] = list(rules)
        self.seed = int(seed)
        self._lock = lockcheck.make_lock("FaultPlan._lock")
        self._hits: dict[str, int] = {}
        self._fired: dict[int, int] = {}
        self._rng = random.Random(self.seed)
        self.injected_total = 0  # plain count: readable with telemetry off

    def reset(self) -> None:
        """Rewind the hit/fired counters and the RNG (same plan, fresh run)."""
        with self._lock:
            self._hits.clear()
            self._fired.clear()
            self._rng = random.Random(self.seed)

    def _match(self, site: str, row: int | None = None, rows=None) -> FaultRule | None:
        with self._lock:
            hit = self._hits.get(site, 0)
            self._hits[site] = hit + 1
            for i, r in enumerate(self.rules):
                if r.site != site or hit < r.after:
                    continue
                fired = self._fired.get(i, 0)
                if r.count >= 0 and fired >= r.count:
                    continue
                if row is not None and r.row is not None and r.row != row:
                    continue
                if rows is not None and r.row is not None and r.row not in rows:
                    # the targeted row is not riding this hit: hold the rule
                    # without consuming its count until the victim shows up
                    continue
                if r.p < 1.0 and self._rng.random() >= r.p:
                    continue
                self._fired[i] = fired + 1
                self.injected_total += 1
                for obs in _fire_observers:
                    try:
                        obs(site, r, row)
                    except Exception:
                        pass
                # resolved per injection, not bound at construction: an
                # env-installed plan exists before --telemetry enables the
                # registry, and injections are rare
                from distributed_llama_tpu_torch import telemetry

                telemetry.counter(
                    "dllama_faults_injected_total",
                    "Faults actually injected by the active chaos plan, by site",
                    labelnames=("site",),
                ).labels(site=site).inc()
                return r
        return None

    def fire(self, site: str, row: int | None = None) -> FaultRule | None:
        """The hook call sites thread through the hot paths: raises for
        ``raise``/``disconnect`` rules, sleeps for ``delay``/``hang``,
        returns the matched rule (or None) otherwise."""
        rule = self._match(site, row=row)
        if rule is None:
            return None
        if rule.kind == "raise":
            raise InjectedFault(rule.message or f"injected fault at {site}")
        if rule.kind == "disconnect":
            raise BrokenPipeError(rule.message or f"injected client disconnect at {site}")
        if rule.kind in ("delay", "hang"):
            ms = rule.delay_ms or (HANG_DEFAULT_MS if rule.kind == "hang" else 0.0)
            time.sleep(ms / 1000.0)
        return rule

    def fires(self, site: str, row: int | None = None, rows=None) -> FaultRule | None:
        """Non-raising variant for data-corruption sites (``kind=nan``,
        ``kind=corrupt``): the call site applies the corruption itself from
        the returned rule. ``rows`` names the rows riding this hit — a
        row-targeted rule holds (count unconsumed) until its victim is
        present."""
        return self._match(site, row=row, rows=rows)


class _NullPlan:
    """Disabled-mode bind target: stateless no-op singleton."""

    __slots__ = ()
    enabled = False
    injected_total = 0

    def fire(self, site: str, row: int | None = None) -> None:
        return None

    def fires(self, site: str, row: int | None = None, rows=None) -> None:
        return None


NULL_PLAN = _NullPlan()

_active: FaultPlan | None = None


def install(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process-wide active plan. Components bind at
    construction — install BEFORE building the engine/scheduler/server."""
    global _active
    _active = plan
    return plan


def clear() -> None:
    global _active
    _active = None


def active_plan() -> FaultPlan | _NullPlan:
    """The bind-once entry point: the active plan, or the no-op singleton."""
    return _active if _active is not None else NULL_PLAN


_INT_FIELDS = ("after", "count", "row")
_FLOAT_FIELDS = ("p", "delay_ms")


def parse(spec: str, seed: int = 0) -> FaultPlan:
    """Parse a fault-plan spec: ``;``-separated ``site:key=val,key=val``
    rules, or a JSON array/object of rule fields."""
    spec = (spec or "").strip()
    rules: list[FaultRule] = []
    if spec.startswith("[") or spec.startswith("{"):
        data = json.loads(spec)
        if isinstance(data, dict):
            data = [data]
        rules = [FaultRule(**d) for d in data]
    else:
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            site, _, kvs = part.partition(":")
            kw: dict = {"site": site.strip()}
            for kv in filter(None, (x.strip() for x in kvs.split(","))):
                k, _, v = kv.partition("=")
                k, v = k.strip(), v.strip()
                if k in _INT_FIELDS:
                    kw[k] = int(v)
                elif k in _FLOAT_FIELDS:
                    kw[k] = float(v)
                elif k in ("kind", "message"):
                    kw[k] = v
                else:
                    raise ValueError(f"unknown fault-rule field {k!r}")
            rules.append(FaultRule(**kw))
    if not rules:
        raise ValueError(f"empty fault plan: {spec!r}")
    return FaultPlan(rules, seed=seed)


_ENV_VAR = "DLLAMA_FAULTS"
_env_spec = os.environ.get(_ENV_VAR, "").strip()
if _env_spec:
    install(parse(_env_spec, seed=int(os.environ.get("DLLAMA_FAULTS_SEED", "0") or 0)))
