"""Supervised data-parallel replica pool.

The port's copy of the core of the JAX package's ``server/replicas.py``. A
replica is one failure domain: an engine with its own weights, its
:class:`~distributed_llama_tpu_torch.engine.batch.BatchScheduler` (slab,
prefix-cache pool) and its serving lanes. :class:`ReplicaPool` owns N
replicas behind one admission front end (server/admission.py
``FairAdmission``) and adds:

* **Placement** — an admitted request lands on the free lane with the best
  chat-prefix affinity, then the best :meth:`ReplicaPool.route_score` (the
  shared prefix index's published chain depth per replica, discounted by
  the replica's load), then the least-loaded replica. Suspect replicas are
  skipped while a healthy one has room; dead replicas never place.
* **Health** — a per-replica walk ``healthy -> suspect -> dead`` driven by
  the scheduler's dispatch round trips (past ``suspect_roundtrip_s`` the
  replica turns suspect, a fast one clears it), the stall watchdog (a stall
  walks suspect, then dead) and hard losses (a crashed dispatch).
* **Supervision** — a dead replica's capacity leaves admission
  (``FairAdmission.resize``), its chains leave the shared index and its
  entries the spill arena, its in-flight requests carry typed
  ``ReplicaLost`` errors that the server requeues and replays bit for bit
  on survivors, and a supervisor thread first releases the dead replica's
  scheduler (its slab and pool) and engine, then rebuilds it under the
  jittered backoff policy (distributed_llama_tpu_torch/retry.py), checks
  the rebuilt weights against the load-time checksum, and swaps it in.
  Restart jitter is entropy-seeded on purpose: replicas restored from one
  image with one seed would retry in lockstep.

Replicas share one card and its default stream: nothing here synchronizes
the device (a ``torch.cuda.synchronize`` would stall every replica).

Lock discipline: ``ReplicaPool._cond`` ranks above the schedulers'
conditions (pyproject's ``[tool.dllama.analysis.locks]``), so a
scheduler's health hook may call into the pool while holding its
condition, but nothing here calls into a scheduler while holding
``_cond`` (the preemption fan-out snapshots the schedulers
first, then calls them unlocked). ``DLT_LOCK_CHECK=1`` witnesses it.

Left out (ROADMAP.md Queue 1: the replica pool's canary, shadow votes and
rollout): the SDC canary and shadow votes, and weight versions with
cordon, drain, grow, retire and rollout.
"""

from __future__ import annotations

import gc
import random
import threading
import time

from distributed_llama_tpu_torch import lockcheck, retry, telemetry
from distributed_llama_tpu_torch.engine import faults, integrity
from distributed_llama_tpu_torch.telemetry import flight


class NoPlaceableReplica(faults.ReplicaLost):
    """Placement found no live replica inside its window. A ReplicaLost, so
    the server's requeue loop retries it through fair admission, but not a
    replay: nothing ran, so ``dllama_replayed_requests_total`` must not
    count it."""


HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"

# dllama_replica_state gauge encoding
STATE_VALUES = {HEALTHY: 0, SUSPECT: 1, DEAD: 2}


class Replica:
    """One failure domain: an engine, its BatchScheduler (or None) and the
    serving lanes riding on it. ``generation`` increments per rebuild, so
    health events from a replaced scheduler never touch its successor."""

    __slots__ = ("idx", "engine", "scheduler", "slots", "state", "generation", "restarts")

    def __init__(self, idx: int, engine, scheduler, slots):
        self.idx = idx
        self.engine = engine
        self.scheduler = scheduler
        self.slots = list(slots)
        self.state = HEALTHY
        self.generation = 0
        self.restarts = 0

    def active(self) -> int:
        return sum(1 for s in self.slots if s.busy)


class ReplicaPool:
    """N supervised replicas behind one placement front door.

    ``build_replica(idx)`` returns ``(engine, scheduler_or_None, slots)``
    (the server's ``ApiState._build_replica``); the pool calls it again,
    under the restart backoff, to rebuild a dead replica. ``admission`` (a
    FairAdmission) is resized as capacity dies and returns. ``tel`` is a
    ServerInstruments bundle. ``supervise=False`` disables the restart loop
    and stall escalation (a lone replica with no engine factory keeps the
    plain StallTimeout semantics)."""

    # one active request on a replica outweighs this many owned prefix
    # blocks in route_score
    ROUTE_LOAD_DISCOUNT = 2.0

    def __init__(self, build_replica, replicas, admission=None, tel=None, supervise: bool = True,
                 suspect_roundtrip_s: float = 30.0, place_timeout_s: float = 5.0,
                 restart_policy: retry.BackoffPolicy | None = None, restart_seed: int | None = None,
                 shared_index=None, spill_arena=None):
        # the shared cache tier: the index the replicas' trees report their
        # chains to (placement routes to the owner of the longest matched
        # chain) and the pool-wide spill arena; a replica's death drops its
        # entries from both
        self.shared_index = shared_index
        self.spill_arena = spill_arena
        self.shared_hits_total = 0
        self.build_replica = build_replica
        self.replicas: list[Replica] = list(replicas)
        self.admission = admission
        self.tel = tel if tel is not None else telemetry.ServerInstruments()
        self.supervise = bool(supervise)
        self.suspect_roundtrip_s = float(suspect_roundtrip_s)
        self.place_timeout_s = float(place_timeout_s)
        self.restart_policy = restart_policy or retry.BackoffPolicy(
            attempts=retry.UNBOUNDED, base_s=0.5, multiplier=2.0, max_s=30.0, jitter_s=0.5)
        # entropy-seeded unless a test pins it (see the module docstring)
        self._rng = random.Random(restart_seed) if restart_seed is not None else random.Random()
        self._cond = lockcheck.make_condition("ReplicaPool._cond")
        self._closed = False
        # plain ledger, readable with telemetry off (the registry's series
        # mirror it)
        self.failovers_total = 0
        self.restarts_total = 0
        self.replayed_total = 0
        self.suspects_total = 0
        self.last_failover_victims = 0
        self.sdc_checks_total = 0
        self.sdc_mismatches_total = 0
        # the load-time weight checksum a rebuild must reproduce
        self.weights_reference: str | None = None
        for r in self.replicas:
            if r.engine is not None:
                try:
                    self.weights_reference = r.engine.weights_checksum()
                except Exception as e:  # a reference is optional (fake replicas)
                    print(f"⚠️ weight checksum unavailable: {e}")
                break
        for r in self.replicas:
            self._adopt(r)

    # ------------------------------------------------------------------
    # Wiring
    # ------------------------------------------------------------------

    def _adopt(self, rep: Replica) -> None:
        """Arm a (re)built replica's scheduler with its pool identity: the
        replica-scoped fault sites, the health hook, and (supervised) stall
        escalation to replica loss."""
        self.tel.replica_state.labels(replica=str(rep.idx)).set(STATE_VALUES[rep.state])
        sched = rep.scheduler
        if sched is None:
            return
        sched.replica_id = rep.idx
        sched.lost_on_stall = self.supervise
        gen = rep.generation
        sched.health_hook = lambda event, value, idx=rep.idx, g=gen: self._on_event(idx, g, event, value)

    def close(self) -> None:
        """Stop supervision and close every replica's scheduler (its
        watchdog, slab and pool)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            scheds = [r.scheduler for r in self.replicas if r.scheduler is not None]
        for s in scheds:
            s.close()

    # ------------------------------------------------------------------
    # Placement
    # ------------------------------------------------------------------

    def all_slots(self) -> list:
        """Every replica's lanes, flattened."""
        return [s for r in self.replicas for s in r.slots]

    def place(self, messages, deadline: float | None = None, route_tokens=None):
        """Claim a free lane for an admitted request: best chat-prefix
        affinity first, then the best :meth:`route_score` over the shared
        index's chain depths (``route_tokens``), then the least-loaded
        replica, preferring an empty chat cache on ties. Healthy replicas
        while any has room, suspect ones as the fallback, dead ones never.
        When nothing is placeable it waits (at most ``place_timeout_s`` and
        the request's ``deadline``), then raises :class:`NoPlaceableReplica`
        (or DeadlineExceeded when the deadline ran out)."""
        shared: dict[int, int] = {}
        if self.shared_index is not None and route_tokens is not None:
            shared = self.shared_index.match(route_tokens)
        limit = time.monotonic() + self.place_timeout_s
        if deadline is not None:
            limit = min(limit, deadline)
        with self._cond:
            while True:
                picked = self._pick_slot_locked(messages, shared)
                if picked is not None:
                    rep, slot = picked
                    slot.busy = True
                    depth = shared.get(rep.idx, 0)
                    best_other = max((d for o, d in shared.items() if o != rep.idx), default=0)
                    if depth > 0 and depth > best_other and slot.cache.match_len(messages) == 0:
                        # the index decided this placement: the replica owns
                        # strictly more of the chain than any other, and chat
                        # affinity did not choose it first
                        self.shared_hits_total += 1
                        self.tel.shared_prefix_hits.inc()
                    return slot
                now = time.monotonic()
                if deadline is not None and now >= deadline:
                    raise faults.DeadlineExceeded("deadline expired waiting for replica placement")
                if now >= limit or self._closed:
                    raise NoPlaceableReplica(
                        "no placeable replica: " + ", ".join(f"{r.idx}:{r.state}" for r in self.replicas))
                self._cond.wait(timeout=limit - now)

    @classmethod
    def route_score(cls, depth_blocks: int, active: int) -> float:
        """Load-discounted depth score of placing on a replica that owns
        ``depth_blocks`` of the prompt's published chain while serving
        ``active`` requests. With no ownership anywhere the ranking is
        least-loaded; among owners each active request discounts
        ROUTE_LOAD_DISCOUNT blocks."""
        return depth_blocks - cls.ROUTE_LOAD_DISCOUNT * active

    def _pick_slot_locked(self, messages, shared=None):
        shared = shared or {}
        for wanted in (HEALTHY, SUSPECT):
            cands = [(r, s) for r in self.replicas if r.state == wanted for s in r.slots if not s.busy]
            if cands:
                return max(cands, key=lambda rs: (
                    rs[1].cache.match_len(messages),
                    self.route_score(shared.get(rs[0].idx, 0), rs[0].active()),
                    -rs[0].active(),
                    0 if rs[1].cache.items else 1,
                ))
        return None

    def release(self, slot) -> None:
        with self._cond:
            slot.busy = False
            slot.tenant = None
            self._cond.notify_all()

    def preempt_below(self, priority: int) -> bool:
        """The admission preempt hook over the pool: evict the globally
        lowest-priority row across live replicas (replicas ranked by their
        own lowest evictable priority). The schedulers are called unlocked
        (their conditions never nest inside the pool's)."""
        with self._cond:
            scheds = [(r.idx, r.scheduler) for r in self.replicas if r.state != DEAD and r.scheduler is not None]
        ranked = []
        for idx, sched in scheds:
            p = sched.min_preemptible_priority()
            if p is not None and p < priority:
                ranked.append((p, idx, sched))
        for _, _, sched in sorted(ranked, key=lambda t: (t[0], t[1])):
            if sched.preempt_below(priority):
                return True
        return False

    def count_replay(self) -> None:
        """One failover victim replayed (the server's requeue loop). Locked:
        a failover's victims requeue concurrently."""
        with self._cond:
            self.replayed_total += 1

    # ------------------------------------------------------------------
    # Health (hook events arrive from scheduler threads, possibly under a
    # scheduler's condition: this side takes only _cond and leaf locks)
    # ------------------------------------------------------------------

    def _on_event(self, idx: int, generation: int, event: str, value: float) -> None:
        start_restart = False
        dump_death = False
        victim_traces: list[str] = []
        with self._cond:
            if idx >= len(self.replicas):
                return
            rep = self.replicas[idx]
            if rep.generation != generation:
                return  # an echo from a replaced scheduler
            if event == "roundtrip":
                if value > self.suspect_roundtrip_s and rep.state == HEALTHY:
                    self._set_state_locked(rep, SUSPECT)
                elif value <= self.suspect_roundtrip_s and rep.state == SUSPECT:
                    self._set_state_locked(rep, HEALTHY)
            elif event == "stall":
                if rep.state == HEALTHY:
                    self._set_state_locked(rep, SUSPECT)
            elif event == "lost" and rep.state != DEAD:
                self._set_state_locked(rep, DEAD)
                # no routing to pages that no longer exist, and no reload of
                # a possibly corrupt replica's spills: both leaf locks,
                # atomic with the death
                if self.shared_index is not None:
                    self.shared_index.drop_owner(idx)
                if self.spill_arena is not None:
                    self.spill_arena.drop_owner(idx)
                self.failovers_total += 1
                # victims = occupied lanes (a request between prefill pieces
                # is in flight but not joined: it replays too)
                self.last_failover_victims = rep.active()
                self.tel.replica_failovers.inc()
                if self.admission is not None:
                    self.admission.resize(-len(rep.slots))
                start_restart = self.supervise and not self._closed
                for s in rep.slots:
                    t = getattr(getattr(s, "stream", None), "trace", None)
                    if t is not None:
                        victim_traces.append(t.request_id)
                flight.record(idx, "failover", victims=self.last_failover_victims,
                              victim_trace_ids=victim_traces, generation=generation)
                dump_death = True
            self._cond.notify_all()
        if dump_death:
            flight.RECORDER.dump(idx, "replica_death", victims=self.last_failover_victims,
                                 victim_trace_ids=victim_traces)
        if start_restart:
            threading.Thread(target=self._restart_loop, args=(idx, generation),
                             name=f"dllama-replica-restart-{idx}", daemon=True).start()

    def _set_state_locked(self, rep: Replica, state: str) -> None:
        if state == SUSPECT and rep.state != SUSPECT:
            self.suspects_total += 1
        if state != rep.state:
            flight.record(rep.idx, "state", frm=rep.state, to=state, generation=rep.generation)
        rep.state = state
        self.tel.replica_state.labels(replica=str(rep.idx)).set(STATE_VALUES[state])

    def mark_dead(self, idx: int, cause: str) -> None:
        """Declare replica ``idx`` dead through its scheduler's own loss path
        (in-flight requests get ReplicaLost, the hook fires back here)."""
        rep = self.replicas[idx]
        if rep.scheduler is not None:
            rep.scheduler.mark_lost(cause)
        else:
            self._on_event(idx, rep.generation, "lost", 0.0)

    # ------------------------------------------------------------------
    # Restart supervision
    # ------------------------------------------------------------------

    def _release_dead(self, idx: int, generation: int) -> None:
        """Free a dead replica's card memory before its rebuild loads weights
        again: close its scheduler (slab and pool) and drop the pool's
        references to it, its engine and its lanes. Victim requests still
        unwinding hold their lane only until they raise ReplicaLost."""
        with self._cond:
            rep = self.replicas[idx] if idx < len(self.replicas) else None
            if rep is None or rep.generation != generation or rep.state != DEAD:
                return
            sched, rep.scheduler, rep.engine, rep.slots = rep.scheduler, None, None, []
        if sched is not None:
            sched.close()
        del sched
        gc.collect()

    def _restart_loop(self, idx: int, generation: int) -> None:
        """Rebuild a dead replica under the jittered backoff policy. The
        release and the build (engine load, scheduler construction) run
        outside the pool lock; the swap-in is atomic under it. A closed pool
        aborts the loop."""
        self._release_dead(idx, generation)

        def build():
            if self._closed:
                raise RuntimeError("pool closed; not restarting")
            engine, scheduler, slots = self.build_replica(idx)
            try:
                self._verify_rebuild(idx, engine)
            except BaseException:
                if scheduler is not None:
                    scheduler.close()
                raise
            return engine, scheduler, slots

        def on_retry(attempt, exc):
            if self._closed:
                raise exc
            print(f"⚠️ replica {idx} restart attempt {attempt + 1} failed: {type(exc).__name__}: {exc}")

        try:
            engine, scheduler, slots = retry.retry_call(build, self.restart_policy, on_retry=on_retry, rng=self._rng)
        except Exception as e:
            print(f"🛑 replica {idx} restart abandoned: {e}")
            return
        with self._cond:
            rep = self.replicas[idx] if idx < len(self.replicas) else None
            if rep is None or self._closed or rep.generation != generation:
                dead = scheduler
            else:
                dead = rep.scheduler
                rep.engine, rep.scheduler, rep.slots = engine, scheduler, list(slots)
                rep.generation += 1
                rep.restarts += 1
                self.restarts_total += 1
                self._set_state_locked(rep, HEALTHY)
                self._adopt(rep)
                self.tel.replica_restarts.inc()
                if self.admission is not None:
                    self.admission.resize(len(rep.slots))
            self._cond.notify_all()
        if dead is not None:
            dead.close()

    def _verify_rebuild(self, idx: int, engine) -> None:
        """A rebuilt replica must reproduce the load-time weight checksum
        before it re-enters placement (the rebuild read the weights through
        the same host RAM, disk and cores that may have corrupted the
        replica). A mismatch raises :class:`integrity.ChecksumMismatch`,
        which the restart loop counts as a failed attempt."""
        want = self.weights_reference
        if engine is None or want is None:
            return
        got = integrity.params_checksum(engine.params)
        with self._cond:
            self.sdc_checks_total += 1
        self.tel.sdc_checks.inc()
        if got != want:
            with self._cond:
                self.sdc_mismatches_total += 1
            self.tel.sdc_mismatches.labels(check="checksum").inc()
            flight.record(idx, "checksum", verdict="mismatch", got=got, want=want)
            raise integrity.ChecksumMismatch(
                f"replica {idx} rebuild checksum {got} != reference {want}; refusing to re-enter placement")
        flight.record(idx, "checksum", verdict="ok")

    # ------------------------------------------------------------------
    # Introspection (/readyz, tests)
    # ------------------------------------------------------------------

    def snapshot(self) -> list[dict]:
        """Per-replica health for the /readyz body."""
        with self._cond:
            return [{"replica": r.idx, "state": r.state, "active_rows": r.active(), "slots": len(r.slots),
                     "restarts": r.restarts, "generation": r.generation, "cache": self._cache_read(r)}
                    for r in self.replicas]

    @staticmethod
    def _cache_read(rep: Replica):
        """Per-replica prefix-cache occupancy (device pages held and pinned,
        arena depth), or None without a prefix cache. Racy integer reads on
        purpose: a snapshot must not take the scheduler's condition (the
        lock order is scheduler, then pool)."""
        prefix = getattr(rep.scheduler, "_prefix", None)
        if prefix is None:
            return None
        return {"pages": prefix.pages_in_use(), "pinned": prefix.pinned_pages(), "spill_depth": prefix.spill_depth()}

    def states(self) -> list[str]:
        with self._cond:
            return [r.state for r in self.replicas]

    def wait_state(self, idx: int, state: str, timeout_s: float = 30.0) -> bool:
        """Block until replica ``idx`` reaches ``state`` (or the timeout)."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self.replicas[idx].state != state:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(timeout=left)
            return True
