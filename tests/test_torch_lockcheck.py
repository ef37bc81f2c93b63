"""The port's runtime lock-order witness (``distributed_llama_tpu_torch.
lockcheck``): the JAX package's witness cases (tests/test_lockcheck.py) on
the port, its rank table against the hierarchy the JAX package declares in
``pyproject.toml``, and the replica failover (crash, replay, restart) on
the port's server with ``DLT_LOCK_CHECK`` armed and no violation recorded.
The seeded-inversion case is the discriminator: a witness that never fires
is indistinguishable from no witness at all.
"""

import re
import threading
import time
import tomllib
from pathlib import Path

import pytest

from distributed_llama_tpu_torch import lockcheck
from distributed_llama_tpu_torch.lockcheck import LockOrderViolation

from tests.test_torch_replicas import files  # noqa: F401  (the replica server's model fixture)

RANKS = {"Sched._cond": 20, "Pool._cond": 40, "Leaf._lock": 80}


@pytest.fixture
def witness():
    lockcheck.configure(ranks=RANKS, mode="raise")
    lockcheck.reset()
    yield lockcheck
    lockcheck.configure()
    lockcheck.reset()


# ----------------------------------------------------------------------
# Factories
# ----------------------------------------------------------------------


def test_factories_are_plain_primitives_when_off():
    lockcheck.configure(mode="off")
    try:
        assert isinstance(lockcheck.make_lock("Pool._cond"), type(threading.Lock()))
        assert isinstance(lockcheck.make_rlock("Pool._cond"), type(threading.RLock()))
        assert isinstance(lockcheck.make_condition("Pool._cond"), threading.Condition)
        assert not lockcheck.enabled()
    finally:
        lockcheck.configure()


def test_unranked_name_stays_plain_even_when_armed(witness):
    assert isinstance(lockcheck.make_lock("Nobody._lock"), type(threading.Lock()))


def test_repo_construction_sites_are_witnessed_when_armed():
    """The port's locks come out wrapped under its own rank table (no
    configure(ranks=...) override)."""
    lockcheck.configure(mode="raise")  # ranks: the declared hierarchy
    try:
        from distributed_llama_tpu_torch.telemetry import flight

        fr = flight.FlightRecorder(capacity=4)
        assert "FlightRecorder._lock" in repr(fr._lock)
    finally:
        lockcheck.configure()


# ----------------------------------------------------------------------
# Order checking
# ----------------------------------------------------------------------


def test_ascending_acquisition_is_clean(witness):
    sched = lockcheck.make_condition("Sched._cond")
    pool = lockcheck.make_condition("Pool._cond")
    leaf = lockcheck.make_lock("Leaf._lock")
    with sched:
        with pool:
            with leaf:
                pass
    assert lockcheck.violations() == []


def test_inversion_raises_and_is_recorded(witness):
    sched = lockcheck.make_condition("Sched._cond")
    pool = lockcheck.make_condition("Pool._cond")
    with pool:
        with pytest.raises(LockOrderViolation, match="lock-order inversion"):
            with sched:
                pass
    assert len(lockcheck.violations()) == 1
    assert "Sched._cond" in lockcheck.violations()[0]


def test_warn_mode_records_without_raising(witness):
    lockcheck.configure(ranks=RANKS, mode="warn")
    pool = lockcheck.make_lock("Pool._cond")
    leaf = lockcheck.make_lock("Leaf._lock")
    with leaf:
        with pool:  # inversion: recorded, not raised
            pass
    assert len(lockcheck.violations()) == 1
    lockcheck.reset()
    assert lockcheck.violations() == []


def test_reentrant_rlock_is_not_a_violation(witness):
    r = lockcheck.make_rlock("Pool._cond")
    with r:
        with r:  # same object, reentrant: exempt by design
            pass
    assert lockcheck.violations() == []


def test_plain_lock_self_reacquire_reports_instead_of_hanging(witness):
    lk = lockcheck.make_lock("Leaf._lock")
    lk.acquire()
    try:
        with pytest.raises(LockOrderViolation, match="self-deadlock"):
            lk.acquire()  # blocking re-acquire: a guaranteed hang
    finally:
        lk.release()
    # a non-blocking probe is a legitimate pattern, not a violation
    lockcheck.reset()
    lk.acquire()
    assert lk.acquire(blocking=False) is False
    lk.release()
    assert lockcheck.violations() == []


def test_trylock_failure_does_not_corrupt_the_stack(witness):
    lk = lockcheck.make_lock("Leaf._lock")
    holder_ready = threading.Event()
    release = threading.Event()

    def holder():
        with lk:
            holder_ready.set()
            release.wait(timeout=5)

    t = threading.Thread(target=holder)
    t.start()
    holder_ready.wait(timeout=5)
    assert lk.acquire(blocking=False) is False  # contended probe fails
    release.set()
    t.join()
    with lk:  # and the probing thread's stack is still coherent
        pass
    assert lockcheck.violations() == []


# ----------------------------------------------------------------------
# Condition integration
# ----------------------------------------------------------------------


def test_condition_wait_releases_and_reclaims(witness):
    cond = lockcheck.make_condition("Pool._cond")
    sched = lockcheck.make_lock("Sched._cond")
    with cond:
        cond.wait(timeout=0.05)  # times out; entries must be re-pushed
        with pytest.raises(LockOrderViolation):
            sched.acquire()  # rank 20 under rank 40: still checked
    sched.acquire()  # after the with: stack drained, clean acquire
    sched.release()


def test_condition_wait_notify_across_threads(witness):
    cond = lockcheck.make_condition("Pool._cond")
    woke = threading.Event()

    def waiter():
        with cond:
            cond.wait(timeout=5)
            woke.set()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        cond.notify_all()
    t.join(timeout=5)
    assert woke.is_set()
    assert lockcheck.violations() == []


def test_waiter_releases_the_lock_for_other_threads(witness):
    """The faithful-release property: while one thread WAITS on the
    witnessed condition, another thread must be able to take it (a witness
    that pinned the entry would turn every wait into a false inversion for
    the notifier)."""
    cond = lockcheck.make_condition("Pool._cond")
    entered = threading.Event()
    results = []

    def waiter():
        with cond:
            entered.set()
            results.append(cond.wait(timeout=5))

    t = threading.Thread(target=waiter)
    t.start()
    entered.wait(timeout=5)
    deadline = time.monotonic() + 5
    acquired = False
    while time.monotonic() < deadline and not acquired:
        with cond:
            cond.notify_all()
            acquired = True
    t.join(timeout=5)
    assert acquired and results == [True]
    assert lockcheck.violations() == []


# ----------------------------------------------------------------------
# The discriminating seeded inversion, on the REAL rank table
# ----------------------------------------------------------------------


def test_seeded_inversion_on_real_ranks_fires_and_shipped_order_passes():
    """Construct two real port locks (FaultPlan rank 70, FlightRecorder
    rank 85): the shipped ascending order runs clean; the deliberately
    inverted order is caught."""
    lockcheck.configure(mode="raise")
    lockcheck.reset()
    try:
        from distributed_llama_tpu_torch.engine import faults
        from distributed_llama_tpu_torch.telemetry import flight

        plan = faults.FaultPlan(rules=[])
        rec = flight.FlightRecorder(capacity=4)
        with plan._lock:  # rank 70 -> 85: the shipped order
            with rec._lock:
                pass
        assert lockcheck.violations() == []
        with rec._lock:  # seeded inversion: 85 held, 70 acquired
            with pytest.raises(LockOrderViolation):
                with plan._lock:
                    pass
        assert len(lockcheck.violations()) == 1
    finally:
        lockcheck.configure()
        lockcheck.reset()


def test_rank_table_is_the_declared_hierarchy():
    """The port reads the hierarchy the JAX package declares in pyproject
    and witnesses (the same table, rank for rank), and every lock the port
    constructs by name is ranked in it."""
    from distributed_llama_tpu import lockcheck as jlockcheck

    root = Path(__file__).resolve().parents[1]
    declared = tomllib.loads((root / "pyproject.toml").read_text())["tool"]["dllama"]["analysis"]["locks"]
    lockcheck.configure()
    jlockcheck.configure()
    assert lockcheck._rank_table() == declared == jlockcheck._rank_table()
    sources = "".join(p.read_text() for p in (root / "distributed_llama_tpu_torch").rglob("*.py"))
    names = set(re.findall(r'make_(?:lock|rlock|condition)\("([^"]+)"\)', sources))
    assert {"BatchScheduler._cond", "ReplicaPool._cond", "HostArena._lock", "FlightRecorder._lock"} <= names
    assert names <= set(declared), names - set(declared)


# ----------------------------------------------------------------------
# The replica failover runs clean under the witness
# ----------------------------------------------------------------------


@pytest.mark.chaos
def test_replica_crash_runs_clean_under_witness(monkeypatch, files):  # noqa: F811
    """The port's crash -> replay -> restart (tests/test_torch_replicas.py)
    with ``DLT_LOCK_CHECK=1`` set before the server is built: every
    scheduler, pool, admission, fault-plan, index, arena and recorder lock
    is witnessed (the ledger records without raising, so a violation reads
    as an assert rather than a dead server thread), and the run records
    none."""
    from distributed_llama_tpu_torch.engine import faults
    from distributed_llama_tpu_torch.telemetry import flight

    from tests.test_torch_replicas import CRASH, HEALTHY, SseStream, make_replica_state, serve_state

    monkeypatch.setenv("DLT_LOCK_CHECK", "1")
    lockcheck.configure(mode="warn")  # ranks: the declared hierarchy
    lockcheck.reset()
    faults.clear()
    saved = flight.RECORDER
    try:
        flight.RECORDER = flight.FlightRecorder()  # a witnessed recorder lock
        assert "_WitnessLock" in repr(flight.RECORDER._lock)
        faults.install(faults.parse(CRASH))
        state = make_replica_state(files)
        assert "_WitnessRLock" in repr(state.pool._cond._lock)
        url, server = serve_state(state)
        try:
            body = {"messages": [{"role": "user", "content": "tell me a very long story"}], "max_tokens": 96}
            streams = [SseStream(url, dict(body)) for _ in range(4)]
            texts = [s.read_all() for s in streams]
            assert all(s.error_type is None for s in streams) and all(texts)
            assert state.pool.failovers_total == 1
            assert state.pool.wait_state(0, HEALTHY, timeout_s=60)
        finally:
            server.shutdown()
            state.close()
        assert lockcheck.violations() == [], lockcheck.violations()
    finally:
        flight.RECORDER = saved
        faults.clear()
        lockcheck.configure()
        lockcheck.reset()
