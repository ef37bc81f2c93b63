"""Multi-tenant weighted-fair admission: bounded per-tenant queues feeding
the serving lanes by deficit-weighted dequeue, with priority classes.

The port's copy of the JAX package's ``server/admission.py``:

* **Per-tenant bounded queues.** A waiter queues under its own tenant; a
  tenant at its ``queue`` limit (or the global ``queue_limit`` cap) gets
  :class:`AdmissionRejected` (429) without touching other tenants' room.
* **Deficit-weighted dequeue** (DRR, Shreedhar & Varghese): when a slot
  frees, each backlogged tenant's deficit is topped up by its ``weight``
  and the richest deficit is served (cost 1 per grant), so sustained
  saturation converges to weight-proportional admission shares and a
  heavy tenant cannot starve a light one. A tenant's deficit resets when
  its queue drains: idle tenants hoard no credit.
* **Priority classes.** Grants consider only queue heads in the highest
  waiting priority class; DRR breaks ties inside the class. The serving
  layer also arms a **preempt hook** so a high-priority arrival can evict a
  lower-priority decode row (engine/batch.py ``preempt_below``) instead of
  waiting behind it; the victim is requeued here, at its own priority.

Invariant: a slot is never free while a waiter is queued (every enqueue and
every release runs the grant loop under the one condition lock), so the
fast path — free slot, no queue — is a single lock round trip.

Tenants are auto-registered on first sight (weight 1, priority 0) so an
unknown ``tenant`` body field serves rather than 500s; ``--tenants``
declares the weighted ones (:func:`parse_tenants`).
"""

from __future__ import annotations

import collections
import dataclasses
import time

from distributed_llama_tpu_torch import lockcheck
from distributed_llama_tpu_torch.engine.faults import DeadlineExceeded

DEFAULT_TENANT = "default"


class AdmissionRejected(RuntimeError):
    """The bounded admission queue (global or per-tenant) is full — mapped
    to HTTP 429 with a jittered ``Retry-After`` header (the alternative is
    an unbounded queue: every queued client holds a socket +
    handler thread while its own timeout burns, then retries into an even
    deeper queue)."""


class ServerDraining(RuntimeError):
    """The server received SIGTERM and stopped admitting — mapped to HTTP
    503 with ``Retry-After`` so load balancers move on while in-flight
    completions finish."""


@dataclasses.dataclass
class TenantConfig:
    """One tenant's admission contract: ``weight`` is its DRR share under
    saturation, ``priority`` the default class for its requests (bodies
    may override per request), ``queue`` its own waiter bound (None =
    the global ``queue_limit`` is the only cap)."""

    name: str
    weight: int = 1
    priority: int = 0
    queue: int | None = None

    def __post_init__(self):
        if self.weight < 1:
            raise ValueError(
                f"tenant {self.name!r}: weight must be >= 1 (got {self.weight})"
            )


def parse_tenants(spec: str | None) -> dict[str, TenantConfig]:
    """Parse ``--tenants``: ``;``-separated ``name:key=val,key=val`` with
    integer fields ``weight``/``priority``/``queue`` — e.g.
    ``"gold:weight=4,priority=10;free:weight=1"``. Empty/None → no
    pre-declared tenants (everyone auto-registers at weight 1)."""
    out: dict[str, TenantConfig] = {}
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, kvs = part.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"tenant spec entry without a name: {part!r}")
        kw: dict = {"name": name}
        for kv in filter(None, (x.strip() for x in kvs.split(","))):
            k, _, v = kv.partition("=")
            k = k.strip()
            if k not in ("weight", "priority", "queue"):
                raise ValueError(f"unknown tenant field {k!r} in {part!r}")
            kw[k] = int(v.strip())
        if name in out:
            raise ValueError(f"duplicate tenant {name!r} in --tenants spec")
        out[name] = TenantConfig(**kw)
    return out


class _Waiter:
    __slots__ = ("tenant", "priority", "granted")

    def __init__(self, tenant: str, priority: int):
        self.tenant = tenant
        self.priority = priority
        self.granted = False


class FairAdmission:
    """``n_slots`` serving permits behind per-tenant bounded queues with
    priority-then-DRR grant order. ``acquire``/``release`` replace a slot
    semaphore; ``queue_limit`` is the GLOBAL waiting cap (per-tenant
    caps come from each :class:`TenantConfig`)."""

    def __init__(
        self,
        n_slots: int,
        tenants: dict[str, TenantConfig] | None = None,
        queue_limit: int = 0,
        max_tenants: int = 256,
    ):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.n_slots = n_slots
        self.queue_limit = max(0, int(queue_limit))
        # auto-registration bound: the tenant field is CLIENT-supplied, so
        # without a cap one client cycling unique names grows the registry,
        # the DRR scan, and the per-tenant metric label sets without limit.
        # Names past the cap fold into the shared DEFAULT_TENANT bucket
        # (still served, weight 1) instead of registering.
        self.max_tenants = max(1, int(max_tenants))
        self._cond = lockcheck.make_condition("FairAdmission._cond")
        self._free = n_slots
        self._tenants: dict[str, TenantConfig] = dict(tenants or {})
        # registration order = the deterministic DRR tie-break order
        self._order: list[str] = list(self._tenants)
        self._queues: dict[str, collections.deque[_Waiter]] = {}
        self._deficit: dict[str, float] = {}
        self._waiting = 0
        self.draining = False
        # armed by the serving layer when a batch scheduler exists: called
        # OUTSIDE the admission lock (it takes the scheduler's cond) with
        # the arriving priority; returns True if a row was evicted
        self.preempt_hook = None
        # plain counters, readable with telemetry off (the loadgen report
        # and tests read these; the registry metrics mirror them)
        self.admitted_total: dict[str, int] = {}
        self.rejected_total: dict[str, int] = {}

    # ------------------------------------------------------------------
    # Tenant registry
    # ------------------------------------------------------------------

    def config(self, tenant: str) -> TenantConfig:
        with self._cond:
            return self._config_locked(tenant)

    def resolve(self, tenant: str) -> str:
        """Canonicalize a client-supplied tenant name: the registered name,
        or — past ``max_tenants`` — the shared DEFAULT_TENANT bucket. The
        serving layer resolves ONCE per request, before any per-tenant
        metric label is minted, so an adversarial name churn cannot grow
        the label sets either."""
        with self._cond:
            return self._config_locked(tenant).name

    def _config_locked(self, tenant: str) -> TenantConfig:
        cfg = self._tenants.get(tenant)
        if cfg is None:
            # unknown tenants serve at weight 1 / priority 0 rather than
            # 500: the tenant field is client-supplied routing metadata,
            # not an auth boundary. Past the registry cap
            # they fold into the shared default bucket (the fold target is
            # always registerable, even at the cap).
            if len(self._tenants) >= self.max_tenants and tenant != DEFAULT_TENANT:
                return self._config_locked(DEFAULT_TENANT)
            cfg = TenantConfig(tenant)
            self._tenants[tenant] = cfg
            self._order.append(tenant)
        return cfg

    def queue_depth(self, tenant: str) -> int:
        with self._cond:
            q = self._queues.get(tenant)
            return len(q) if q else 0

    def waiting(self) -> int:
        with self._cond:
            return self._waiting

    def free_slots(self) -> int:
        with self._cond:
            return self._free

    def rejected_count(self) -> int:
        """Total 429s across every tenant."""
        with self._cond:
            return sum(self.rejected_total.values())

    # ------------------------------------------------------------------
    # Acquire / release
    # ------------------------------------------------------------------

    def acquire(
        self, tenant: str = DEFAULT_TENANT, priority: int = 0,
        deadline: float | None = None, trace=None,
    ) -> None:
        """Take one serving permit for ``tenant`` at ``priority``, queueing
        BOUNDEDLY behind its own tenant queue when all slots are busy.
        Raises :class:`AdmissionRejected` (→429) past the queue bounds,
        :class:`DeadlineExceeded` (→504) when ``deadline`` (a
        ``time.monotonic`` instant) expires in line, and
        :class:`ServerDraining` (→503) on SIGTERM drain.

        ``trace``: the request's TraceContext, annotated when
        the request actually QUEUED — a fast-path grant leaves no note, so
        a trace's queue_wait span plus this note distinguish "waited in
        line behind N others" from "walked straight in"."""
        with self._cond:
            cfg = self._config_locked(tenant)
            tenant = cfg.name  # canonical: past max_tenants, the default bucket
            if self.draining:
                raise ServerDraining("server is draining; not admitting")
            if self._free > 0:
                # fast path; the grant loop keeps the no-free-while-queued
                # invariant, so no waiter can be bypassed here
                self._free -= 1
                self.admitted_total[tenant] = self.admitted_total.get(tenant, 0) + 1
                return
            q = self._queues.setdefault(tenant, collections.deque())
            tenant_cap = cfg.queue if cfg.queue is not None else self.queue_limit
            if self._waiting >= self.queue_limit or len(q) >= tenant_cap:
                self.rejected_total[tenant] = self.rejected_total.get(tenant, 0) + 1
                raise AdmissionRejected(
                    f"admission queue full for tenant {tenant!r} "
                    f"({len(q)} tenant waiters, {self._waiting} total, "
                    f"limit {min(tenant_cap, self.queue_limit)})"
                )
            w = _Waiter(tenant, priority)
            q.append(w)
            self._waiting += 1
            queued_behind = self._waiting
        if trace is not None:
            trace.note(
                admission_queued=True, admission_waiters=queued_behind
            )
        # priority preemption happens OUTSIDE the admission lock: the hook
        # takes the batch scheduler's condition lock, and holding both
        # would order them admission→scheduler while the release path
        # orders scheduler→admission (the evicted thread's unwind)
        hook = self.preempt_hook
        if hook is not None and priority > 0:
            hook(priority)
        try:
            with self._cond:
                while not w.granted:
                    if self.draining:
                        raise ServerDraining(
                            "server is draining; not admitting"
                        )
                    if deadline is not None:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            raise DeadlineExceeded(
                                "deadline expired while queued for admission"
                            )
                        self._cond.wait(timeout=left)
                    else:
                        self._cond.wait()
        except BaseException:
            with self._cond:
                self._abandon_locked(w)
            raise
        with self._cond:
            self._waiting -= 1
            self.admitted_total[tenant] = self.admitted_total.get(tenant, 0) + 1

    def resize(self, delta: int) -> None:
        """Grow or shrink serving capacity by ``delta`` permits — the
        replica pool's lever: a replica declared DEAD removes
        its slots (``_free`` may go transiently negative while the dead
        replica's in-flight requests still hold permits; their unwinding
        releases rebalance it), a restarted replica adds them back and
        grants queued waiters. Capacity may reach 0 (every replica dead):
        new requests then queue/429 until a restart succeeds."""
        with self._cond:
            n = self.n_slots + int(delta)
            if n < 0:
                raise ValueError(
                    f"resize({delta}) would make capacity negative "
                    f"(currently {self.n_slots})"
                )
            self.n_slots = n
            self._free += int(delta)
            if delta > 0:
                self._grant_locked()
            self._cond.notify_all()

    def release(self) -> None:
        """Return one permit and grant it onward (priority class first,
        DRR within the class)."""
        with self._cond:
            self._free += 1
            if self._free > self.n_slots:
                raise RuntimeError("release() without a matching acquire()")
            self._grant_locked()
            self._cond.notify_all()

    def _abandon_locked(self, w: _Waiter) -> None:
        """Unwind a waiter that raised (deadline/drain/interrupt) out of
        the wait loop: drop it from its queue — or, if a grant landed in
        the race window, give the permit straight back."""
        self._waiting -= 1
        if w.granted:
            self._free += 1
            self._grant_locked()
        else:
            q = self._queues.get(w.tenant)
            if q is not None:
                try:
                    q.remove(w)
                except ValueError:
                    pass
                if not q:
                    self._deficit[w.tenant] = 0.0
        self._cond.notify_all()

    # ------------------------------------------------------------------
    # Grant policy: priority class first, deficit round-robin inside it
    # ------------------------------------------------------------------

    def _grant_locked(self) -> None:
        while self._free > 0:
            w = self._pick_locked()
            if w is None:
                return
            self._free -= 1
            w.granted = True

    def _pick_locked(self) -> _Waiter | None:
        backlogged = [t for t in self._order if self._queues.get(t)]
        if not backlogged:
            return None
        # only the highest waiting priority class competes: within a
        # tenant the queue is FIFO, so the class is judged at queue heads
        top = max(self._queues[t][0].priority for t in backlogged)
        cls = [t for t in backlogged if self._queues[t][0].priority == top]
        # DRR: top everyone in the class up by their weight until someone
        # can afford the grant (cost 1); weight >= 1 bounds this to one
        # round. Deterministic: dict order is registration order.
        while True:
            best = max(cls, key=lambda t: (self._deficit.get(t, 0.0), -cls.index(t)))
            if self._deficit.get(best, 0.0) >= 1.0:
                break
            for t in cls:
                self._deficit[t] = (
                    self._deficit.get(t, 0.0) + self._tenants[t].weight
                )
        self._deficit[best] -= 1.0
        q = self._queues[best]
        w = q.popleft()
        if not q:
            # classic DRR: an emptied queue forfeits its residue — idle
            # tenants must not bank credit against future contention
            self._deficit[best] = 0.0
        return w

    # ------------------------------------------------------------------
    # Drain (SIGTERM)
    # ------------------------------------------------------------------

    def begin_drain(self) -> None:
        """Stop admitting: queued waiters bounce with ServerDraining,
        in-flight permits finish normally. Idempotent."""
        with self._cond:
            self.draining = True
            self._cond.notify_all()

    def drain_wait(self, timeout_s: float) -> bool:
        """Block until every permit is back (all in-flight completions
        finished), capped at ``timeout_s``. Returns True when fully
        drained."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        with self._cond:
            while self._free < self.n_slots:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(timeout=left)
            return True
