"""Runtime lock-order witness: ``DLT_LOCK_CHECK``.

The port's copy of the JAX package's ``lockcheck.py``. Every named lock
construction site of the port calls :func:`make_lock` / :func:`make_rlock`
/ :func:`make_condition` with its "Class._attr" name, and when the witness
is armed each acquisition is checked against a per-thread stack of held
ranks: acquiring a rank <= any held rank (on a different lock) is a
violation, as is a blocking re-acquire of a plain (non-reentrant) Lock by
its own holder (a guaranteed self-deadlock, reported before the thread
hangs). The orders it watches exist only at run time: the scheduler's
``health_hook`` into the replica pool, the pool's resize of admission, the
restart supervisor, fault fires recorded into the flight recorder.

Off by default and free when off: the factories return plain ``threading``
primitives unless armed. Arming:

* ``DLT_LOCK_CHECK=1`` (or ``raise``): violations raise
  :class:`LockOrderViolation` at the acquisition site (and are recorded).
* ``DLT_LOCK_CHECK=warn``: violations are only recorded; read them with
  :func:`violations`.
* :func:`configure`: explicit mode/ranks for tests.

The mode is read when a lock is constructed (set the variable before the
pool or scheduler is built). The rank table loads lazily from the repo's
``pyproject.toml`` (``[tool.dllama.analysis.locks]``), the hierarchy the
JAX package declares and witnesses too.

``Condition.wait`` is handled faithfully: waiting releases the lock, so
the witness pops its entries for the wait and re-pushes them on wakeup
without an order check (the wakeup re-acquire is not a nesting).
"""

from __future__ import annotations

import os
import threading
import tomllib
from pathlib import Path

__all__ = [
    "LockOrderViolation",
    "configure",
    "enabled",
    "make_condition",
    "make_lock",
    "make_rlock",
    "reset",
    "violations",
]


class LockOrderViolation(RuntimeError):
    """A runtime lock acquisition violated the declared hierarchy."""


# the declared lock hierarchy: acquire strictly by ascending rank (a thread
# holding rank R may only acquire ranks > R; leaf locks are max-rank)
PYPROJECT = Path(__file__).resolve().parents[1] / "pyproject.toml"


_tls = threading.local()  # .held: list[(name, rank, id(lock-obj))]
_ledger_lock = threading.Lock()
_ledger: list[str] = []
_ranks_override: dict[str, int] | None = None
_ranks_cache: dict[str, int] | None = None
_mode_override: str | None = None  # "raise" | "warn" | "off"


def configure(
    ranks: dict[str, int] | None = None, mode: str | None = None
) -> None:
    """Test hook: pin the rank table and/or mode ("raise"/"warn"/"off")
    instead of reading pyproject / the environment. ``None`` restores the
    default source for that setting."""
    global _ranks_override, _mode_override, _ranks_cache
    _ranks_override = dict(ranks) if ranks is not None else None
    _mode_override = mode
    _ranks_cache = None


def _active_mode() -> str:
    if _mode_override is not None:
        return _mode_override
    v = os.environ.get("DLT_LOCK_CHECK", "").strip().lower()
    if v in ("1", "true", "on", "raise"):
        return "raise"
    if v == "warn":
        return "warn"
    return "off"


def enabled() -> bool:
    return _active_mode() != "off"


def _rank_table() -> dict[str, int]:
    """The declared hierarchy, read once from the repo's ``pyproject.toml``
    (``[tool.dllama.analysis.locks]``); empty (nothing ranked, nothing
    checked) where the file is missing or unreadable."""
    global _ranks_cache
    if _ranks_override is not None:
        return _ranks_override
    if _ranks_cache is None:
        try:
            with open(PYPROJECT, "rb") as f:
                _ranks_cache = dict(tomllib.load(f)["tool"]["dllama"]["analysis"]["locks"])
        except (OSError, KeyError, tomllib.TOMLDecodeError):
            _ranks_cache = {}
    return _ranks_cache


def violations() -> list[str]:
    """The recorded violations (both modes record before raising)."""
    with _ledger_lock:
        return list(_ledger)


def reset() -> None:
    with _ledger_lock:
        _ledger.clear()


def _held() -> list:
    st = getattr(_tls, "held", None)
    if st is None:
        st = _tls.held = []
    return st


def _violate(mode: str, message: str) -> None:
    with _ledger_lock:
        _ledger.append(message)
    if mode == "raise":
        raise LockOrderViolation(message)


def _check_order(mode: str, name: str, rank: int, obj_id: int) -> None:
    for held_name, held_rank, held_id in _held():
        if held_id == obj_id:
            continue
        if held_rank >= rank:
            _violate(
                mode,
                f"lock-order inversion: acquiring `{name}` (rank {rank})"
                f" while `{held_name}` (rank {held_rank}) is held — the"
                " declared hierarchy ([tool.dllama.analysis.locks])"
                " requires strictly ascending ranks",
            )


class _WitnessLock:
    """A non-reentrant Lock under the witness. A blocking re-acquire by
    the holding thread is reported as a violation INSTEAD of deadlocking
    the test run."""

    def __init__(self, name: str, rank: int, mode: str):
        self._name, self._rank, self._mode = name, rank, mode
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held()
        mine = id(self)
        if blocking and any(h[2] == mine for h in held):
            _violate(
                self._mode,
                f"self-deadlock: `{self._name}` re-acquired (blocking) by"
                " the thread that already holds it — threading.Lock is"
                " not reentrant",
            )
        _check_order(self._mode, self._name, self._rank, mine)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            held.append((self._name, self._rank, mine))
        return ok

    def release(self) -> None:
        self._inner.release()
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][2] == id(self):
                del held[i]
                break

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<_WitnessLock {self._name} rank={self._rank}>"


class _WitnessRLock:
    """A reentrant lock under the witness; also the lock a witnessed
    Condition is built over. Implements the ``_release_save`` /
    ``_acquire_restore`` / ``_is_owned`` protocol ``threading.Condition``
    uses, popping the witness entries across a ``wait`` (which releases
    the lock) and re-pushing them on wakeup without an order check."""

    def __init__(self, name: str, rank: int, mode: str):
        self._name, self._rank, self._mode = name, rank, mode
        self._inner = threading.RLock()

    def _mine(self) -> int:
        return sum(1 for h in _held() if h[2] == id(self))

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._mine() == 0:
            _check_order(self._mode, self._name, self._rank, id(self))
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _held().append((self._name, self._rank, id(self)))
        return ok

    def release(self) -> None:
        self._inner.release()
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][2] == id(self):
                del held[i]
                break

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- the Condition integration protocol -----------------------------

    def _release_save(self):
        state = self._inner._release_save()
        held = _held()
        n = 0
        for i in range(len(held) - 1, -1, -1):
            if held[i][2] == id(self):
                del held[i]
                n += 1
        return (state, n)

    def _acquire_restore(self, saved) -> None:
        state, n = saved
        self._inner._acquire_restore(state)
        held = _held()
        for _ in range(n):
            # wakeup re-acquire: exempt from the order check by design
            held.append((self._name, self._rank, id(self)))

    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def __repr__(self) -> str:
        return f"<_WitnessRLock {self._name} rank={self._rank}>"


def make_lock(name: str) -> threading.Lock:
    """A ``threading.Lock`` for the construction site ``name``
    ("Class._attr"); witness-wrapped when the checker is armed AND the
    name is ranked in the declared hierarchy."""
    mode = _active_mode()
    if mode == "off":
        return threading.Lock()
    rank = _rank_table().get(name)
    if rank is None:
        return threading.Lock()
    return _WitnessLock(name, rank, mode)


def make_rlock(name: str) -> threading.RLock:
    mode = _active_mode()
    if mode == "off":
        return threading.RLock()
    rank = _rank_table().get(name)
    if rank is None:
        return threading.RLock()
    return _WitnessRLock(name, rank, mode)


def make_condition(name: str) -> threading.Condition:
    """A ``threading.Condition`` whose underlying (reentrant) lock is
    witnessed — ``with cond:`` / ``cond.acquire`` check the hierarchy,
    ``cond.wait`` releases and reclaims without a spurious check."""
    mode = _active_mode()
    if mode == "off":
        return threading.Condition()
    rank = _rank_table().get(name)
    if rank is None:
        return threading.Condition()
    return threading.Condition(_WitnessRLock(name, rank, mode))
