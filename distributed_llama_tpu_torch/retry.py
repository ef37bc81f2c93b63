"""One retry/backoff vocabulary for the port.

The port's copy of the JAX package's ``retry.py``:

* :class:`BackoffPolicy` — a frozen description of the schedule: total
  ``attempts`` (``UNBOUNDED`` = keep trying), exponential delay
  ``base_s * multiplier**n`` capped at ``max_s``, plus up to ``jitter_s``
  of uniform additive jitter drawn from a caller-supplied RNG.
  **Seeded-jitter contract:** the policy never owns entropy — callers pass
  ``random.Random(seed)`` when determinism matters (tests, chaos replays)
  and an entropy-seeded RNG when it must not.
* :func:`retry_call` — run a callable under a policy: failures matching
  ``retry_on`` sleep the policy's delay and try again; the last failure
  re-raises when attempts are exhausted. ``on_retry(attempt, exc)`` runs
  before each sleep (metrics hooks; raising from it aborts the loop).

``retry_call`` catches only ``retry_on`` (default ``Exception``):
KeyboardInterrupt/SystemExit always propagate, so a Ctrl-C aborts instead
of being retried into a quarantine.
"""

from __future__ import annotations

import dataclasses
import time

UNBOUNDED = -1


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """An immutable retry schedule. ``attempts`` counts TOTAL tries
    (``1`` = no retry at all, :data:`UNBOUNDED` = retry forever);
    ``delay_s(n)`` is the wait after failed attempt ``n`` (0-based):
    ``min(base_s * multiplier**n, max_s)`` plus ``uniform(0, jitter_s)``
    from the caller's RNG."""

    attempts: int
    base_s: float = 0.0
    multiplier: float = 2.0
    max_s: float = float("inf")
    jitter_s: float = 0.0

    def __post_init__(self):
        if self.attempts == 0 or self.attempts < UNBOUNDED:
            raise ValueError(f"attempts must be >= 1 or UNBOUNDED, got {self.attempts}")
        if self.base_s < 0 or self.max_s < 0 or self.jitter_s < 0:
            raise ValueError("delays must be non-negative")
        if self.multiplier < 1.0:
            raise ValueError(f"multiplier must be >= 1 (got {self.multiplier}): a "
                             "shrinking backoff is a retry storm with extra steps")

    def delay_s(self, attempt: int, rng=None) -> float:
        """Seconds to wait after failed attempt ``attempt`` (0-based)."""
        # the exponent is capped at 1023: float**int overflows past ~1.8e308,
        # and an UNBOUNDED loop must keep retrying at max_s
        d = min(self.base_s * self.multiplier ** min(attempt, 1023), self.max_s)
        if self.jitter_s > 0.0 and rng is not None:
            d += rng.uniform(0.0, self.jitter_s)
        return d

    def more(self, attempt: int) -> bool:
        """True when attempt index ``attempt`` (0-based) is allowed."""
        return self.attempts == UNBOUNDED or attempt < self.attempts


def retry_call(fn, policy: BackoffPolicy, *, retry_on=Exception, on_retry=None, sleep=time.sleep, rng=None):
    """Call ``fn()`` under ``policy``. Returns ``fn``'s result on the first
    success; re-raises the last failure once attempts are exhausted. Only
    exceptions matching ``retry_on`` are retried — anything else (including
    KeyboardInterrupt/SystemExit) propagates at once. ``on_retry(attempt,
    exc)`` runs before each backoff sleep with the 0-based failed-attempt
    index; an exception raised from it propagates. ``sleep``/``rng`` are
    injectable for tests."""
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            if not policy.more(attempt + 1):
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            d = policy.delay_s(attempt, rng)
            if d > 0.0:
                sleep(d)
            attempt += 1
