"""Per-replica flight recorder: the black box that survives a replica.

The port's copy of the JAX package's ``telemetry/flight.py``. A bounded
per-replica ring of structured lifecycle events, always on (the events are
rare: state transitions, fault fires, row quarantines, checksum verdicts,
failovers, watchdog stalls, spill CRC drops), and an auto-dump of the
victim's ring on replica death or a watchdog stall. Live at ``GET
/debug/flight`` (server/api.py), printable with ``python -m
distributed_llama_tpu_torch.telemetry.dump --flight``, and asserted by the
load generator's ``--expect-flight`` gate.

The fault-fire feed hooks :meth:`FaultPlan._match` through
``faults.add_fire_observer``: every actual injection is recorded with the
site that fired, so a dump names the chaos rule behind an injected death.

Lock discipline: the recorder's lock is a leaf (records arrive from under
the scheduler's condition, the pool's and the fault plan's own lock).
Nothing here calls out while holding it; an optional ``dump_dir`` file
write happens on a daemon thread.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

from distributed_llama_tpu_torch import lockcheck

# unattributed events (a fault fire with no row/replica context) land here
UNSCOPED = -1

MAX_EVENTS_PER_REPLICA = 512
MAX_DUMPS = 16


class FlightRecorder:
    def __init__(
        self,
        capacity: int = MAX_EVENTS_PER_REPLICA,
        max_dumps: int = MAX_DUMPS,
        dump_dir: str | None = None,
    ):
        self.capacity = max(1, int(capacity))
        self.max_dumps = max(1, int(max_dumps))
        self.dump_dir = dump_dir
        self._lock = lockcheck.make_lock("FlightRecorder._lock")
        self._epoch = time.perf_counter()
        self._rings: dict[int, collections.deque] = {}
        self._dumps: collections.deque = collections.deque(maxlen=self.max_dumps)
        self._seq = 0
        self.recorded_total = 0
        self.dumps_total = 0

    def record(self, replica: int, kind: str, **fields) -> None:
        """Append one lifecycle event to ``replica``'s ring. ``fields``
        must be JSON-serializable scalars/lists (the dump is the wire
        format)."""
        ev = {
            "seq": 0,  # patched under the lock: a global order across rings
            "t_s": round(time.perf_counter() - self._epoch, 6),
            "replica": int(replica),
            "kind": kind,
        }
        ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            ring = self._rings.get(int(replica))
            if ring is None:
                ring = collections.deque(maxlen=self.capacity)
                self._rings[int(replica)] = ring
            ring.append(ev)
            self.recorded_total += 1

    def dump(self, replica: int, reason: str, **fields) -> dict:
        """Snapshot ``replica``'s ring into the bounded dump list (the
        auto-dump on death/SDC/stall). Returns the dump object; when
        ``dump_dir`` is set the JSON artifact is also written from a
        daemon thread (never under a caller's lock)."""
        with self._lock:
            events = list(self._rings.get(int(replica), ()))
            self.dumps_total += 1
            n = self.dumps_total
        d = {
            "dump": n,
            "t_s": round(time.perf_counter() - self._epoch, 6),
            "replica": int(replica),
            "reason": reason,
            "events": events,
        }
        d.update(fields)
        with self._lock:
            self._dumps.append(d)
        if self.dump_dir:
            path = os.path.join(
                self.dump_dir, f"dllama-flight-r{int(replica)}-{n}.json"
            )
            threading.Thread(
                target=self._write, args=(path, d),
                name="dllama-flight-dump", daemon=True,
            ).start()
        return d

    @staticmethod
    def _write(path: str, d: dict) -> None:
        try:
            # written aside and renamed: a reader never sees a partial dump
            with open(path + ".tmp", "w") as f:
                json.dump(d, f, indent=2)
            os.replace(path + ".tmp", path)
            print(f"🛬 flight recorder dump written: {path}")
        except Exception as e:
            print(f"⚠️ flight recorder dump write failed: {e}")

    def snapshot(self) -> dict:
        """The live view served at /debug/flight: every ring plus the
        retained dumps."""
        with self._lock:
            return {
                "recorded_total": self.recorded_total,
                "dumps_total": self.dumps_total,
                "replicas": {
                    str(rid): list(ring) for rid, ring in self._rings.items()
                },
                "dumps": list(self._dumps),
            }

    def dumps(self) -> list[dict]:
        with self._lock:
            return list(self._dumps)

    def clear(self) -> None:
        with self._lock:
            self._rings.clear()
            self._dumps.clear()


# The process-wide recorder (always on — lifecycle events are rare enough
# that there is nothing to gate; components call record() directly).
RECORDER = FlightRecorder()


def record(replica: int, kind: str, **fields) -> None:
    RECORDER.record(replica, kind, **fields)


def _on_fault_fire(site: str, rule, row) -> None:
    """faults.add_fire_observer hook: every actual injection lands in the
    ring of the row/replica the rule targeted (``row=`` selects the
    replica id for replica.*/engine.sdc/engine.spill sites and the batch
    row elsewhere, recorded as-is; UNSCOPED when untargeted)."""
    RECORDER.record(
        UNSCOPED if row is None else int(row),
        "fault_fire",
        site=site,
        fault_kind=getattr(rule, "kind", ""),
    )


_installed = False


def install_fault_observer() -> None:
    """Wire the recorder into the fault plan's injection point. Idempotent;
    the import is deferred so this module stays importable without the
    engine package (the dump CLI's remote mode)."""
    global _installed
    if _installed:
        return
    from distributed_llama_tpu_torch.engine import faults

    faults.add_fire_observer(_on_fault_fire)
    _installed = True
