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
* **Integrity** — the SDC canary (:meth:`ReplicaPool.canary_tick`) runs the
  server's pinned greedy probe through each live replica's real batched
  path and compares ``(tokens, fingerprint)`` with its weight version's
  golden: a mismatch walks the replica suspect, ``fail_threshold`` in a row
  declare it dead as corrupt (its victims get ``ReplicaCorrupt``). A shadow
  vote (:meth:`ReplicaPool.shadow_vote`) re-runs a greedy request on a
  random pair of replicas; a divergence turns both suspect and the canary
  resolves them.
* **Weight versions and fleet primitives** — every replica serves a
  ``weights_version``, each live version has its own checksum reference and
  canary golden, and a per-slot target version (:meth:`target_version`)
  steers every rebuild. Cordon, drain, the synchronous rebuild, grow,
  retire and certification are the mechanisms the rollout orchestrator and
  the fleet controller (server/fleet.py) sequence.

A replica's engine may be a tensor-parallel one (``--tp``: its scheduler's
slab and pool are per-rank) or one slice of a one-process pod
(parallel/pod.py, ``--pod``): there the factory is the pod group, so a
rebuild, a grow or a rollout move hands out a fresh slice engine over the
group's shared params (never a weight reload), and the release of a dead
slice frees its scheduler and lanes while the shared tree stays.

Replicas share one card and its default stream: nothing here synchronizes
the device (a ``torch.cuda.synchronize`` would stall every replica). A
synchronous rebuild builds the new engine before the old one is released,
so a rollout move briefly holds one replica more on the card.

Lock discipline: ``ReplicaPool._cond`` ranks above the schedulers'
conditions (pyproject's ``[tool.dllama.analysis.locks]``), so a
scheduler's health hook may call into the pool while holding its
condition, but nothing here calls into a scheduler while holding
``_cond`` (the preemption fan-out snapshots the schedulers
first, then calls them unlocked; a canary verdict marks a replica lost
after releasing ``_cond``). ``DLT_LOCK_CHECK=1`` witnesses it.
"""

from __future__ import annotations

import gc
import random
import threading
import time
import traceback

from distributed_llama_tpu_torch import lockcheck, retry, telemetry
from distributed_llama_tpu_torch.engine import faults, integrity
from distributed_llama_tpu_torch.telemetry import Stopwatch, flight


def _drop_failed_build(exc: BaseException) -> None:
    """Free a failed build's card memory now, not when its exception dies:
    the traceback's finished frames (the checksum gate's, a mutation's) hold
    its engine, so they are cleared and collected before anything is built
    next (a retry, a rollback)."""
    traceback.clear_frames(exc.__traceback__)
    gc.collect()


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
    health events from a replaced scheduler never touch its successor.
    ``integrity``, ``last_canary`` and ``canary_fails`` are the canary's
    record of it; ``weights_version`` names the weights it serves, and
    ``cordoned`` keeps new placements off it (a rollout's drain) with no
    health meaning."""

    __slots__ = ("idx", "engine", "scheduler", "slots", "state", "generation", "restarts", "integrity",
                 "last_canary", "canary_fails", "weights_version", "cordoned")

    def __init__(self, idx: int, engine, scheduler, slots):
        self.idx = idx
        self.engine = engine
        self.scheduler = scheduler
        self.slots = list(slots)
        self.state = HEALTHY
        self.generation = 0
        self.restarts = 0
        self.integrity = "unverified"
        self.last_canary: float | None = None
        self.canary_fails = 0
        self.weights_version = "v0"
        self.cordoned = False

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
                 shared_index=None, spill_arena=None, weights_version: str = "v0"):
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
        # the canary: the server's probe, its cadence and mismatch threshold
        self.canary_probe = None
        self.canary_interval_s = 0.0
        self.canary_fail_threshold = 2
        self._canary_thread: threading.Thread | None = None
        # per weight version: the canary golden and the load-time checksum a
        # rebuild must reproduce (within a version every replica is bit
        # identical; a retired version's entries leave with it)
        self.weights_version = str(weights_version)
        self._canary_goldens: dict[str, object] = {}
        self.weights_reference: dict[str, str] = {}
        # the rollout's per-slot target versions (they override the pool
        # version mid-rollout, so every rebuild, the supervisor's too,
        # converges on the rollout's intent) and its state
        self._slot_versions: dict[int, str] = {}
        self.rollout: dict | None = None
        self.rollout_moves_total = 0
        self.rollout_aborts_total = 0
        for r in self.replicas:
            r.weights_version = self.weights_version
        for r in self.replicas:
            if r.engine is not None:
                try:
                    self.weights_reference[self.weights_version] = r.engine.weights_checksum()
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
        escalation to replica loss. A (re)built replica starts unverified:
        the next canary pass certifies it against its version's golden."""
        self.tel.replica_state.labels(replica=str(rep.idx)).set(STATE_VALUES[rep.state])
        rep.integrity = "unverified"
        rep.last_canary = None
        rep.canary_fails = 0
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
        index's chain depths (``route_tokens``), then (mid-rollout) the
        target version, then the least-loaded replica, preferring an empty
        chat cache on ties. Healthy replicas while any has room, suspect
        ones as the fallback, dead and cordoned ones never.
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
        # mid-rollout, placement prefers the target version below affinity
        # and routing depth: traffic shifts to upgraded replicas as they
        # certify, and old-version lanes still serve when they are all
        # that is free
        target = self.rollout["to"] if self.rollout else None
        for wanted in (HEALTHY, SUSPECT):
            cands = [(r, s) for r in self.replicas if r.state == wanted and not r.cordoned
                     for s in r.slots if not s.busy]
            if cands:
                return max(cands, key=lambda rs: (
                    rs[1].cache.match_len(messages),
                    self.route_score(shared.get(rs[0].idx, 0), rs[0].active()),
                    1 if target and rs[0].weights_version == target else 0,
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
    # Integrity: the SDC canary and shadow votes. The probe (the server's
    # ApiState._canary_probe) runs a pinned greedy prompt through a
    # replica's real batched path on a directly claimed lane (no admission
    # permit, billed to integrity.CANARY_TENANT) and returns (tokens,
    # fingerprint), or None when inconclusive (every lane busy, the probe
    # preempted, the replica lost mid-probe).
    # ------------------------------------------------------------------

    def claim_slot(self, idx: int, tenant: str | None = None):
        """Claim a free lane of replica ``idx`` directly, past fair
        admission (the canary, shadow and certification path), preferring
        the lane with the emptiest chat cache (a probe resets its stream).
        None when every lane is busy or the replica is dead or the pool
        closed: a probe is skipped, never queued. Cordoned replicas stay
        claimable."""
        with self._cond:
            rep = self.replicas[idx]
            if rep.state == DEAD or self._closed:
                return None
            free = [s for s in rep.slots if not s.busy]
            if not free:
                return None
            slot = min(free, key=lambda s: len(s.cache.items))
            slot.busy = True
            slot.tenant = tenant
            return slot

    def start_canary(self, probe, interval_s: float, fail_threshold: int = 2) -> None:
        """Arm the canary with ``probe(replica, messages=None)``.
        ``interval_s > 0`` starts the background thread; 0 arms manual
        :meth:`canary_tick` only (and the shadow votes, which reuse the
        probe)."""
        self.canary_probe = probe
        self.canary_fail_threshold = max(1, int(fail_threshold))
        self.canary_interval_s = 0.0 if interval_s is None else float(interval_s)
        if self.canary_interval_s > 0 and self._canary_thread is None:
            self._canary_thread = threading.Thread(target=self._canary_loop, name="dllama-sdc-canary", daemon=True)
            self._canary_thread.start()

    def _canary_loop(self) -> None:
        while True:
            with self._cond:
                # a monotonic deadline: the condition is notified on every
                # lane release and health event, so a bare wait(interval)
                # would tick at traffic frequency
                deadline = time.monotonic() + self.canary_interval_s
                while not self._closed:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(timeout=left)
                if self._closed:
                    return
            try:
                self.canary_tick()
            except Exception as e:  # a health instrument never takes the pool down
                print(f"⚠️ sdc canary tick failed: {type(e).__name__}: {e}")

    def canary_tick(self) -> int:
        """One canary pass over the live replicas; returns the number of
        conclusive probes. A weight version's first conclusive result is its
        golden; every later probe compares with its replica's version
        golden. A match certifies the replica (and clears a suspect one); a
        mismatch walks it suspect, and ``canary_fail_threshold`` in a row
        declare it dead as corrupt: its victims get ReplicaCorrupt, which
        the server never splices onto deltas already sent."""
        probe = self.canary_probe
        if probe is None:
            return 0
        with self._cond:
            if self._closed:
                return 0
            todo = [(r, r.generation) for r in self.replicas if r.state != DEAD]
        conclusive = 0
        for rep, gen in todo:
            sw = Stopwatch()
            try:
                result = probe(rep)
            except Exception as e:
                print(f"⚠️ canary probe on replica {rep.idx} failed: {type(e).__name__}: {e}")
                result = None
            if result is not None:
                # conclusive probes only: a busy-lane skip takes microseconds
                self.tel.canary_latency.observe(sw.elapsed_s())
            kill = False
            with self._cond:
                if self._closed:
                    return conclusive
                if rep.generation != gen or rep.state == DEAD or result is None:
                    continue  # replaced or died mid-probe, or inconclusive
                conclusive += 1
                rep.last_canary = time.monotonic()
                self.sdc_checks_total += 1
                self.tel.sdc_checks.inc()
                golden = self._canary_goldens.get(rep.weights_version)
                if golden is None:
                    self._canary_goldens[rep.weights_version] = result
                    rep.integrity = "ok"
                    rep.canary_fails = 0
                    flight.record(rep.idx, "canary", verdict="golden_set", version=rep.weights_version)
                elif result == golden:
                    rep.integrity = "ok"
                    rep.canary_fails = 0
                    flight.record(rep.idx, "canary", verdict="ok", version=rep.weights_version)
                    if rep.state == SUSPECT:
                        # a pinned greedy round trip through the real path
                        # matching the golden clears it like a fast one
                        self._set_state_locked(rep, HEALTHY)
                else:
                    rep.integrity = "mismatch"
                    rep.canary_fails += 1
                    self.sdc_mismatches_total += 1
                    self.tel.sdc_mismatches.labels(check="canary").inc()
                    flight.record(rep.idx, "canary", verdict="mismatch", fails=rep.canary_fails,
                                  threshold=self.canary_fail_threshold, version=rep.weights_version)
                    if rep.canary_fails >= self.canary_fail_threshold:
                        kill = True
                    elif rep.state == HEALTHY:
                        self._set_state_locked(rep, SUSPECT)
            if kill:
                # outside _cond: mark_lost takes the scheduler's condition and
                # its hook comes back into _on_event (scheduler, then pool)
                cause = (f"silent data corruption: {rep.canary_fails} consecutive canary mismatches against the "
                         f"{rep.weights_version} golden")
                if rep.scheduler is not None:
                    rep.scheduler.mark_lost(cause, corrupt=True)
                else:
                    self._on_event(rep.idx, gen, "lost", 0.0)
        return conclusive

    def shadow_vote(self, probe, messages) -> bool | None:
        """Re-run a greedy request's ``messages`` on two live replicas
        (a random pair from the entropy RNG, so replicas past index 1 are
        covered too) and compare (tokens, fingerprint). With two opinions
        the minority is unknowable: a divergence turns both suspect and
        the canary resolves them. True agree, False diverged, None
        inconclusive."""
        with self._cond:
            live = [r for r in self.replicas if r.state != DEAD]
            if len(live) < 2 or self._closed:
                return None
            pair = self._rng.sample(live, 2)
        votes = [probe(rep, messages) for rep in pair]
        if any(v is None for v in votes):
            return None
        with self._cond:
            self.sdc_checks_total += 1
            self.tel.sdc_checks.inc()
            if votes[0] == votes[1]:
                return True
            self.sdc_mismatches_total += 1
            self.tel.sdc_mismatches.labels(check="shadow").inc()
            for rep in pair:
                flight.record(rep.idx, "shadow", verdict="diverged", pair=[r.idx for r in pair])
                if rep.state == HEALTHY:
                    self._set_state_locked(rep, SUSPECT)
            self._cond.notify_all()
            return False

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
            except BaseException as e:
                if scheduler is not None:
                    scheduler.close()
                del engine, scheduler, slots
                _drop_failed_build(e)
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
                # the version this slot should run, not the dying replica's
                rep.weights_version = self.target_version(idx)
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
        """A rebuilt replica must reproduce the load-time weight checksum of
        the version its slot should run before it re-enters placement (the
        rebuild read the weights through the same host RAM, disk and cores
        that may have corrupted the replica). A mismatch raises
        :class:`integrity.ChecksumMismatch`, which the restart loop counts
        as a failed attempt and a rollout as a failed move."""
        version = self.target_version(idx)
        want = self.weights_reference.get(version)
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
            flight.record(idx, "checksum", verdict="mismatch", got=got, want=want, version=version)
            raise integrity.ChecksumMismatch(f"replica {idx} rebuild checksum {got} != {version} reference {want}; "
                                             "refusing to re-enter placement")
        flight.record(idx, "checksum", verdict="ok", version=version)

    # ------------------------------------------------------------------
    # Weight versions and fleet primitives. The pool owns the mechanisms
    # (per-slot target versions, cordon, drain, the synchronous rebuild,
    # grow, retire, per-version checksums and goldens); server/fleet.py
    # owns the policy. Builds run unlocked, swaps are atomic under _cond
    # and generation-guarded, and no scheduler is called under _cond.
    # ------------------------------------------------------------------

    def target_version(self, idx: int) -> str:
        """The weight version slot ``idx`` should run: the rollout's pin
        when one is set, else the pool version. Every rebuild path builds
        and verifies this version."""
        with self._cond:
            return self._slot_versions.get(idx, self.weights_version)

    def set_slot_version(self, idx: int, version: str) -> None:
        """Pin slot ``idx``'s target version (a rollout's first act per
        move, so a death at any later point rebuilds on it)."""
        with self._cond:
            self._slot_versions[idx] = str(version)

    def register_version(self, version: str, checksum: str | None) -> None:
        """Record a version's load-time checksum reference, the gate of
        every replica built on it; ``None`` leaves any entry alone."""
        if checksum is None:
            return
        with self._cond:
            self.weights_reference[str(version)] = str(checksum)

    def retire_version(self, version: str) -> None:
        """Drop a version's checksum reference and canary golden once no
        replica serves it (a rolled-back target leaves no stale golden)."""
        with self._cond:
            self.weights_reference.pop(version, None)
            self._canary_goldens.pop(version, None)

    def set_cordon(self, idx: int, cordoned: bool) -> None:
        """Keep replica ``idx`` out of (or let it back into) new
        placements. Its lanes stay claimable for probes and its in-flight
        requests stream to their end."""
        with self._cond:
            self.replicas[idx].cordoned = bool(cordoned)
            self._cond.notify_all()

    def drain_replica(self, idx: int, timeout_s: float = 30.0) -> bool:
        """Cordon replica ``idx`` and wait until its lanes are free (or it
        died: its victims are replaying elsewhere). False at the cap; the
        cordon stays on either way (the caller lifts it)."""
        self.set_cordon(idx, True)
        deadline = time.monotonic() + float(timeout_s)
        with self._cond:
            while True:
                rep = self.replicas[idx]
                if rep.state == DEAD or rep.active() == 0:
                    return True
                left = deadline - time.monotonic()
                if left <= 0 or self._closed:
                    return False
                self._cond.wait(timeout=left)

    def rebuild_replica(self, idx: int, mutate=None) -> bool:
        """Rebuild replica ``idx`` now, on ``target_version(idx)``, through
        the factory and the checksum gate (a rollout's cutover). The new
        engine is built before the old one is released; the swap is atomic
        and generation-guarded, so a racing supervisor rebuild makes this
        one discard its build and return False. ``mutate`` (the
        ``server.rollout`` ``kind=corrupt`` payload) acts on the fresh
        engine before the gate, which trips as for a real corruption.
        Raises on a failed build or gate."""
        with self._cond:
            gen = self.replicas[idx].generation
        engine, scheduler, slots = self.build_replica(idx)
        try:
            if mutate is not None and engine is not None:
                mutate(engine)
            self._verify_rebuild(idx, engine)
        except BaseException as e:
            if scheduler is not None:
                scheduler.close()
            del engine, scheduler, slots
            _drop_failed_build(e)  # before the caller's rollback builds again
            raise
        with self._cond:
            rep = self.replicas[idx]
            if self._closed or rep.generation != gen:
                dead, swapped = scheduler, False
            else:
                was_dead = rep.state == DEAD
                dead = rep.scheduler
                rep.engine, rep.scheduler, rep.slots = engine, scheduler, list(slots)
                rep.generation += 1
                rep.weights_version = self.target_version(idx)
                self._set_state_locked(rep, HEALTHY)
                self._adopt(rep)
                if was_dead and self.admission is not None:
                    # death resized this capacity out; it returns here
                    self.admission.resize(len(rep.slots))
                swapped = True
            self._cond.notify_all()
        del engine, scheduler, slots
        if dead is not None:
            # on a lost race our own build, on a win the replaced scheduler:
            # closed outside the condition and collected now, so its
            # engine's card memory is free before the next build
            dead.close()
            del dead
            gc.collect()
        return swapped

    def grow_replica(self):
        """Append one replica (scale-up), built through the factory and the
        checksum gate. It joins at the end, so indices stay dense. Returns
        its index, or None when the pool closed or a concurrent grow won."""
        with self._cond:
            if self._closed:
                return None
            idx = len(self.replicas)
        engine, scheduler, slots = self.build_replica(idx)
        try:
            self._verify_rebuild(idx, engine)
        except BaseException as e:
            if scheduler is not None:
                scheduler.close()
            del engine, scheduler, slots
            _drop_failed_build(e)
            raise
        rep = Replica(idx, engine, scheduler, slots)
        del engine, slots
        with self._cond:
            if self._closed or len(self.replicas) != idx:
                dead = scheduler
            else:
                dead = None
                rep.weights_version = self.target_version(idx)
                self.replicas.append(rep)
                self._adopt(rep)
                if self.admission is not None:
                    self.admission.resize(len(rep.slots))
                self._cond.notify_all()
        del scheduler, rep
        if dead is not None:
            dead.close()
            del dead
            gc.collect()
            return None
        return idx

    def retire_replica(self, drain_timeout_s: float = 10.0) -> bool:
        """Drain and remove the last replica (scale-down; survivors keep
        dense indices). False on a one-replica pool. A missed drain still
        retires: the leftover requests take the failover path (typed
        ReplicaLost, requeue, replay on a survivor)."""
        with self._cond:
            if self._closed or len(self.replicas) <= 1:
                return False
            idx = len(self.replicas) - 1
        drained = self.drain_replica(idx, timeout_s=drain_timeout_s)
        with self._cond:
            if self._closed or len(self.replicas) - 1 != idx:
                return False  # raced a concurrent grow or retire
            rep = self.replicas.pop()
            # orphan a supervisor rebuild in flight for this slot
            rep.generation += 1
            self._slot_versions.pop(idx, None)
            was_dead = rep.state == DEAD
            if self.shared_index is not None:
                self.shared_index.drop_owner(idx)
            if self.spill_arena is not None:
                self.spill_arena.drop_owner(idx)
            if self.admission is not None and not was_dead:
                self.admission.resize(-len(rep.slots))  # a death already removed it
            flight.record(idx, "retire", drained=drained, state=rep.state)
            self._cond.notify_all()
        sched = rep.scheduler
        if sched is not None and not drained and not was_dead:
            # undrained work replays through fair admission; marked lost
            # outside _cond (the hook finds the slot gone)
            sched.mark_lost(f"replica {idx} retired (elastic scale-down)")
        del rep
        if sched is not None:
            sched.close()
            del sched
            gc.collect()  # the retired engine's card memory goes now
        return True

    def certify_replica(self, idx: int, result) -> bool:
        """Compare one conclusive probe ``result`` with replica ``idx``'s
        version golden, setting it when this is the version's first (the
        rollout's first moved replica records the new version's golden).
        Counts an SDC check; a mismatch counts one and returns False (the
        rollout aborts; no health walk here)."""
        with self._cond:
            rep = self.replicas[idx]
            version = rep.weights_version
            rep.last_canary = time.monotonic()
            self.sdc_checks_total += 1
            self.tel.sdc_checks.inc()
            golden = self._canary_goldens.get(version)
            if golden is None:
                self._canary_goldens[version] = result
                rep.integrity = "ok"
                rep.canary_fails = 0
                flight.record(idx, "canary", verdict="golden_set", version=version)
                return True
            if result == golden:
                rep.integrity = "ok"
                rep.canary_fails = 0
                flight.record(idx, "canary", verdict="ok", version=version)
                return True
            rep.integrity = "mismatch"
            self.sdc_mismatches_total += 1
            self.tel.sdc_mismatches.labels(check="canary").inc()
            flight.record(idx, "canary", verdict="mismatch", version=version)
            return False

    def rollout_status(self) -> dict:
        """The ``/readyz`` ``rollout`` field: ``{"active": False}`` at rest,
        else a copy of the rollout's state (active, from, to, moved,
        total)."""
        with self._cond:
            return {"active": False} if self.rollout is None else dict(self.rollout)

    # ------------------------------------------------------------------
    # Introspection (/readyz, tests)
    # ------------------------------------------------------------------

    def snapshot(self) -> list[dict]:
        """Per-replica health for the /readyz body: state, load, restarts,
        weights version, generation, cordon, prefix-cache occupancy, and the
        canary's verdict ("unverified" until this generation's first
        conclusive probe) with its age."""
        now = time.monotonic()
        with self._cond:
            return [{"replica": r.idx, "state": r.state, "active_rows": r.active(), "slots": len(r.slots),
                     "restarts": r.restarts, "weights_version": r.weights_version, "generation": r.generation,
                     "cordoned": r.cordoned, "cache": self._cache_read(r), "integrity": r.integrity,
                     "last_canary_age_s": None if r.last_canary is None else round(now - r.last_canary, 3)}
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
