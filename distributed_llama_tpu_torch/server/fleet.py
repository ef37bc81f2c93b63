"""Fleet operations: blue-green weight rollout and replica-count elasticity.

The port's copy of the JAX package's ``server/fleet.py``: pure policy over
the replica pool's mechanisms (server/replicas.py owns cordon, drain,
rebuild, grow, retire and the per-version integrity anchors).

:class:`RolloutOrchestrator` moves the pool to a new weight version one
replica at a time:

1. pin the slot's target version (``set_slot_version``, first, so a death at
   any later point makes the supervisor rebuild on the new version);
2. cordon and drain: no new placements land on the replica and its
   in-flight requests finish (past the drain cap they take the failover
   path: typed ``ReplicaLost``, requeue, replay on a survivor);
3. rebuild through the new version's engine factory behind its checksum;
4. certify against the new version's canary golden (the first moved replica
   records it) on a direct lane claim billed to the reserved ``_rollout``
   tenant;
5. uncordon; placement prefers the new version as replicas certify.

Any failure (checksum gate, certification, rebuild window) aborts the whole
rollout with :class:`RolloutAborted`: every moved replica is drained and
rebuilt on the old version and the new version's checksum reference and
golden are retired. A server drain mid-rollout aborts without rollback
rebuilds (the process is exiting; every version still serving keeps its own
golden).

:class:`FleetController` grows the pool by one replica after ``up_ticks``
consecutive ticks of pressure (admission queue depth plus new 429s) and
retires the last replica after ``down_ticks`` consecutive idle ticks, within
``min_replicas``/``max_replicas``; capacity moves through
``FairAdmission.resize`` both ways. It shares the ops lock with the
orchestrator and never acts while a rollout holds it.

On a pod (parallel/pod.py) each version's factory is a ``PodGroup``: a
rollout's target is a sibling group, a second params tree over the same
backend; grow and retire add and drop slices over the current version's
tree; and dropping the old version's factory at completion
(``on_rollout_complete``) frees the old tree with the old group.

The ``server.rollout`` fault site fires once per move with ``row=`` the
replica id: ``kind=corrupt`` perturbs the new engine before the checksum
gate, ``raise`` fails certification, ``delay``/``hang`` hold the cutover
window open.
"""

from __future__ import annotations

import threading
import time

from distributed_llama_tpu_torch import lockcheck
from distributed_llama_tpu_torch.engine import faults, integrity
from distributed_llama_tpu_torch.server import replicas
from distributed_llama_tpu_torch.telemetry import flight


class RolloutAborted(RuntimeError):
    """A rollout failed its checksum gate, its certification or its rebuild
    window and was rolled back (or the server began draining mid-rollout);
    ``dllama_rollout_aborts_total`` counts it."""


class RolloutConflict(RuntimeError):
    """A rollout was refused before it started: another fleet operation
    holds the ops lock, the version is unknown or already served, or the
    pool is unsupervised (no restart path converges a mid-rollout death)."""


class _Draining(RuntimeError):
    """The server began draining mid-rollout: abort without rollback."""


class RolloutOrchestrator:
    """Sequences blue-green rollouts over ``state.pool``. ``state`` is the
    server's ApiState: its versioned engine factories
    (``has_weights_version``), the certification probe (``_canary_probe``)
    and the completion hook (``on_rollout_complete``). ``ops_lock`` is shared
    with the FleetController."""

    def __init__(self, state, drain_timeout_s: float = 15.0, rebuild_timeout_s: float = 60.0,
                 certify_attempts: int = 50, ops_lock: threading.Lock | None = None):
        self.state = state
        self.drain_timeout_s = float(drain_timeout_s)
        self.rebuild_timeout_s = float(rebuild_timeout_s)
        self.certify_attempts = max(1, int(certify_attempts))
        self._ops = ops_lock if ops_lock is not None else lockcheck.make_lock("RolloutOrchestrator._ops")
        self._faults = faults.active_plan()  # bind-once, as every fault consumer
        # the last rollout's per-move seconds (drain, rebuild, certify)
        self.last_moves: list[dict] = []

    def run(self, to_version: str, checksum: str | None = None) -> dict:
        """Roll the whole pool to ``to_version``, one replica at a time, and
        return the completion summary; raises :class:`RolloutConflict`
        (nothing started) or :class:`RolloutAborted` (rolled back)."""
        to_version = str(to_version)
        if not self._ops.acquire(blocking=False):
            raise RolloutConflict("another fleet operation (rollout or scale) is in progress")
        try:
            # _ops IS held: acquired non-blocking above so a concurrent
            # caller gets a typed 409 instead of queueing behind us.
            return self._run_locked(to_version, checksum)  # dllama: noqa[LCK-001]
        finally:
            self._ops.release()

    def _run_locked(self, to_version: str, checksum: str | None) -> dict:
        pool = self.state.pool
        if pool.rollout is not None:
            raise RolloutConflict("a rollout is already active")
        if to_version == pool.weights_version:
            raise RolloutConflict(f"pool already serves weights_version {to_version!r}")
        if not self.state.has_weights_version(to_version):
            raise RolloutConflict(f"unknown weights_version {to_version!r}: register it first (selfhost "
                                  "--rollout-weights, or POST /admin/rollout with a \"weights\" path)")
        if not pool.supervise:
            raise RolloutConflict("rollout needs a supervised pool: a replica death mid-rollout converges through "
                                  "the restart supervisor")
        pool.register_version(to_version, checksum)
        from_version = pool.weights_version
        with pool._cond:
            total = len(pool.replicas)
            pool.rollout = {"active": True, "from": from_version, "to": to_version, "moved": 0, "total": total}
        flight.record(-1, "rollout", phase="start", frm=from_version, to=to_version, total=total)
        self.last_moves = []
        try:
            for idx in range(total):
                if getattr(self.state, "draining", False) or pool._closed:
                    raise _Draining("server draining mid-rollout; aborting without rollback rebuilds")
                mutate, force_mismatch, delay_s = None, False, 0.0
                rule = self._faults.fires("server.rollout", row=idx)
                if rule is not None:
                    if rule.kind == "corrupt":
                        mutate = _corrupt_engine
                    elif rule.kind in ("raise", "nan", "disconnect"):
                        force_mismatch = True
                    elif rule.kind in ("delay", "hang"):
                        delay_s = (rule.delay_ms or faults.HANG_DEFAULT_MS) / 1000.0
                self._move_one(idx, to_version, mutate, force_mismatch, delay_s)
                with pool._cond:
                    if pool.rollout is not None:
                        pool.rollout["moved"] += 1
                    pool.rollout_moves_total += 1
                pool.tel.rollout_moved.inc()
                flight.record(idx, "rollout", phase="moved", to=to_version)
        except _Draining as e:
            with pool._cond:
                pool.rollout = None
                pool.rollout_aborts_total += 1
            pool.tel.rollout_aborts.inc()
            flight.record(-1, "rollout", phase="abort", reason="draining", to=to_version)
            raise RolloutAborted(str(e)) from e
        except BaseException as e:
            self._rollback(from_version, to_version)
            flight.record(-1, "rollout", phase="abort", reason=f"{type(e).__name__}: {e}", to=to_version)
            raise RolloutAborted(f"rollout to {to_version!r} aborted and rolled back to {from_version!r}: "
                                 f"{type(e).__name__}: {e}") from e
        # completion: the pool version flips, the pins clear, the old
        # version's anchors retire and the server drops its factory
        with pool._cond:
            moved = pool.rollout["moved"] if pool.rollout else total
            pool.weights_version = to_version
            pool._slot_versions.clear()
            pool.rollout = None
        pool.retire_version(from_version)
        self.state.on_rollout_complete(from_version, to_version)
        flight.record(-1, "rollout", phase="complete", frm=from_version, to=to_version, moved=moved)
        return {"status": "complete", "from": from_version, "to": to_version, "moved": moved,
                "replicas": len(pool.replicas)}

    def _move_one(self, idx: int, to_version: str, mutate, force_mismatch: bool, delay_s: float) -> None:
        """One replica's cutover: pin, drain, rebuild (checksum gate),
        certify (canary gate), uncordon. Raises at any gate."""
        pool = self.state.pool
        pool.set_slot_version(idx, to_version)  # first: a death below rebuilds on it
        times: dict = {"replica": idx}
        self.last_moves.append(times)
        try:
            t0 = time.perf_counter()
            drained = pool.drain_replica(idx, timeout_s=self.drain_timeout_s)
            if delay_s > 0:
                time.sleep(delay_s)  # server.rollout delay/hang: the window held open
            times["drain_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            if not drained:
                # the drain cap: the lingering requests fail over and the
                # supervisor rebuilds, on the pinned version
                pool.mark_dead(idx, f"rollout drain cap ({self.drain_timeout_s}s) exceeded; escalating to failover")
                swapped = False
            else:
                swapped = pool.rebuild_replica(idx, mutate=mutate)
            if not swapped and not pool.wait_state(idx, replicas.HEALTHY, timeout_s=self.rebuild_timeout_s):
                raise RuntimeError(f"replica {idx} did not return healthy within {self.rebuild_timeout_s}s of its "
                                   "cutover")
            times["rebuild_s"] = time.perf_counter() - t0
            rep = pool.replicas[idx]
            if rep.weights_version != to_version:
                raise RuntimeError(f"replica {idx} came back serving {rep.weights_version!r}, expected "
                                   f"{to_version!r}")
            if force_mismatch:
                raise faults.InjectedFault(f"injected canary mismatch certifying replica {idx} on {to_version!r}")
            t0 = time.perf_counter()
            result = None
            for _ in range(self.certify_attempts):
                result = self._probe(idx)
                if result is not None:
                    break
                time.sleep(0.05)
            if result is None:
                raise RuntimeError(f"replica {idx} certification inconclusive after {self.certify_attempts} probe "
                                   "attempts")
            if not pool.certify_replica(idx, result):
                raise RuntimeError(f"replica {idx} canary-certification MISMATCH against the {to_version!r} golden")
            times["certify_s"] = time.perf_counter() - t0
        finally:
            pool.set_cordon(idx, False)

    def _probe(self, idx: int):
        """One certification probe on replica ``idx`` under the reserved
        ``_rollout`` tenant; None (inconclusive) is retried by the caller."""
        rep = self.state.pool.replicas[idx]
        try:
            return self.state._canary_probe(rep, tenant=integrity.ROLLOUT_TENANT)
        except Exception as e:
            print(f"⚠️ rollout certification probe on replica {idx} failed: {type(e).__name__}: {e}")
            return None

    def _rollback(self, from_version: str, to_version: str) -> None:
        """Converge the pool back on ``from_version``: re-pin every slot,
        drain and rebuild each replica that moved, retire the failed
        version's anchors, count the abort. Never raises: a replica whose
        rollback rebuild fails is marked dead for the supervisor (whose pin
        now says the old version)."""
        pool = self.state.pool
        with pool._cond:
            idxs = list(range(len(pool.replicas)))
            for i in idxs:
                pool._slot_versions[i] = from_version
        for i in idxs:
            try:
                with pool._cond:
                    if i >= len(pool.replicas):
                        continue
                    rep = pool.replicas[i]
                    needs = rep.weights_version == to_version and rep.state != replicas.DEAD
                if needs:
                    pool.drain_replica(i, timeout_s=self.drain_timeout_s)
                    pool.rebuild_replica(i)
            except Exception as e:
                print(f"⚠️ rollback rebuild of replica {i} failed ({type(e).__name__}: {e}); handing to supervisor")
                try:
                    pool.mark_dead(i, f"rollback rebuild failed: {e}")
                except Exception:
                    pass
            finally:
                try:
                    pool.set_cordon(i, False)
                except Exception:
                    pass
        with pool._cond:
            pool._slot_versions.clear()
            pool.rollout = None
            pool.rollout_aborts_total += 1
        pool.tel.rollout_aborts.inc()
        pool.retire_version(to_version)


def _corrupt_engine(engine) -> None:
    """The ``server.rollout`` ``kind=corrupt`` payload: perturb the freshly
    built engine's weights in place (``integrity.corrupt_params`` on its own
    params tree, on its device) before the checksum gate sees them."""
    engine.params, _ = integrity.corrupt_params(engine.params, copy=getattr(engine, "shares_params", False))


class FleetController:
    """Replica-count elasticity over ``state.pool``. One :meth:`tick` reads
    the pressure (admission queue depth plus new 429s since the last tick);
    after ``up_ticks`` consecutive ticks at ``queue_high`` or more it grows
    one replica (factory and checksum gate), after ``down_ticks``
    consecutive idle ticks (no pressure, and the survivors' free lanes could
    take the last replica's) it drains and retires the last one.
    ``interval_s > 0`` ticks on a daemon thread; 0 ticks by hand."""

    def __init__(self, state, min_replicas: int = 1, max_replicas: int | None = None, interval_s: float = 0.0,
                 queue_high: int | None = None, up_ticks: int = 2, down_ticks: int = 5, drain_timeout_s: float = 10.0,
                 ops_lock: threading.Lock | None = None):
        self.state = state
        pool = state.pool
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = int(max_replicas) if max_replicas is not None else len(pool.replicas)
        # the default threshold: one replica's lanes' worth of queued demand
        if queue_high is None:
            queue_high = len(pool.replicas[0].slots) if pool.replicas else 1
        self.queue_high = max(1, int(queue_high))
        self.up_ticks = max(1, int(up_ticks))
        self.down_ticks = max(1, int(down_ticks))
        self.drain_timeout_s = float(drain_timeout_s)
        self._ops = ops_lock if ops_lock is not None else lockcheck.make_lock("FleetController._ops")
        self._up_streak = 0
        self._down_streak = 0
        self._last_rejected = 0
        # plain ledger (dllama_fleet_scale_events_total{direction} mirrors it)
        self.scale_events = {"up": 0, "down": 0}
        self.interval_s = 0.0 if interval_s is None else float(interval_s)
        self._thread: threading.Thread | None = None
        if self.interval_s > 0:
            self._thread = threading.Thread(target=self._loop, name="dllama-fleet-controller", daemon=True)
            self._thread.start()

    def pressure(self) -> int:
        """Queue depth plus the rejects since the last read (a full bounded
        queue rejects instead of growing)."""
        adm = self.state.pool.admission
        if adm is None:
            return 0
        rejected = adm.rejected_count()
        fresh = max(0, rejected - self._last_rejected)
        self._last_rejected = rejected
        return adm.waiting() + fresh

    def tick(self) -> str | None:
        """One decision: "up" or "down" when the fleet changed, else None.
        Skips (and resets the streaks) while a rollout runs, the pool is
        closed or the server drains."""
        pool = self.state.pool
        if not self._ops.acquire(blocking=False):
            return None
        try:
            if pool._closed or getattr(self.state, "draining", False) or pool.rollout is not None:
                self._up_streak = self._down_streak = 0
                return None
            # _ops IS held: acquired non-blocking above so elasticity
            # skips the tick instead of queueing behind a rollout.
            return self._tick_locked(pool)  # dllama: noqa[LCK-001]
        finally:
            self._ops.release()

    def _tick_locked(self, pool) -> str | None:
        adm = pool.admission
        if adm is None:
            return None
        pressure = self.pressure()
        n = len(pool.replicas)
        if pressure >= self.queue_high and n < self.max_replicas:
            self._down_streak = 0
            self._up_streak += 1
            if self._up_streak < self.up_ticks:
                return None
            self._up_streak = 0
            try:
                idx = pool.grow_replica()
            except Exception as e:
                print(f"⚠️ fleet scale-up failed: {type(e).__name__}: {e}")
                return None
            if idx is None:
                return None
            self.scale_events["up"] += 1
            pool.tel.fleet_scale.labels(direction="up").inc()
            flight.record(idx, "scale", direction="up", replicas=len(pool.replicas))
            return "up"
        if pressure == 0 and n > self.min_replicas and self._last_idle(pool, adm):
            self._up_streak = 0
            self._down_streak += 1
            if self._down_streak < self.down_ticks:
                return None
            self._down_streak = 0
            if not pool.retire_replica(drain_timeout_s=self.drain_timeout_s):
                return None
            self.scale_events["down"] += 1
            pool.tel.fleet_scale.labels(direction="down").inc()
            flight.record(len(pool.replicas), "scale", direction="down", replicas=len(pool.replicas))
            return "down"
        # hysteresis counts consecutive evidence only
        self._up_streak = 0
        self._down_streak = 0
        return None

    @staticmethod
    def _last_idle(pool, adm) -> bool:
        """The shrink precondition: the last replica holds no work and the
        survivors' free lanes could take its whole capacity."""
        with pool._cond:
            if not pool.replicas:
                return False
            last = pool.replicas[-1]
            if last.active() > 0:
                return False
            lanes = len(last.slots)
        return adm.free_slots() >= lanes

    def _loop(self) -> None:
        pool = self.state.pool
        while True:
            with pool._cond:
                # a monotonic deadline, as the canary loop's
                deadline = time.monotonic() + self.interval_s
                while not pool._closed:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    pool._cond.wait(timeout=left)
                if pool._closed:
                    return
            try:
                self.tick()
            except Exception as e:
                print(f"⚠️ fleet controller tick failed: {type(e).__name__}: {e}")
