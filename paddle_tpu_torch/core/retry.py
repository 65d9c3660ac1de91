"""Retry, backoff and deadline schedule: one implementation of the "try
again, but not forever" policy (port of ``paddle_tpu/core/retry.py``,
whole; stdlib only).

Exponential backoff doubling from a base, +/-50% jitter so a retry storm
decorrelates, a per-call retry budget, and a wall-clock deadline that
overrides everything: checked BEFORE the budget, and clipping the last
sleep so a schedule never oversleeps its own deadline. The serving router
(``serving/router.py``) schedules replica failover with it and the
cluster controller (``serving/cluster.py``) respawn pacing.

Mechanism only: ``RetrySchedule`` decides *whether* and *how long*; the
caller performs the attempt, counts its own telemetry and raises its own
typed errors.

Usage::

    sched = RetryPolicy(max_retries=8, backoff=0.05, deadline=30.0).start()
    while True:
        try:
            return attempt(timeout=sched.remaining(default=None))
        except TransientError as e:
            outcome, delay = sched.note_failure()
            if outcome == DEADLINE:
                raise MyDeadlineError(...) from e
            if outcome == EXHAUSTED:
                raise MyError(...) from e
            time.sleep(delay)
"""

from __future__ import annotations

import random
import time
from typing import Optional, Tuple

# note_failure() outcomes
RETRY = "retry"          # sleep the returned delay, then attempt again
DEADLINE = "deadline"    # the wall-clock deadline elapsed — stop now
EXHAUSTED = "exhausted"  # the retry budget is spent — stop now


class RetryPolicy:
    """Immutable description of a retry schedule.

    max_retries: failed attempts beyond the first that may be retried
        (0 = one attempt, no retry).
    backoff: base seconds for exponential backoff — attempt k sleeps
        ~ backoff * 2**(k-1), jittered.
    deadline: total wall-clock budget in seconds for the whole schedule;
        None (or <= 0) disables it.
    max_delay: cap on a single backoff sleep.
    jitter: fractional +/- spread on each delay (0.5 -> uniform in
        [0.5x, 1.5x)); 0 disables.
    """

    __slots__ = ("max_retries", "backoff", "deadline", "max_delay", "jitter")

    def __init__(self, max_retries: int = 8, backoff: float = 0.05,
                 deadline: Optional[float] = None, max_delay: float = 1.0,
                 jitter: float = 0.5):
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        self.deadline = float(deadline) if deadline and deadline > 0 else None
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)

    def start(self, rng: Optional[random.Random] = None) -> "RetrySchedule":
        """Open one schedule (one logical call's retry state)."""
        return RetrySchedule(self, rng=rng)

    def __repr__(self):
        return (f"RetryPolicy(max_retries={self.max_retries}, "
                f"backoff={self.backoff}, deadline={self.deadline}, "
                f"max_delay={self.max_delay}, jitter={self.jitter})")


class RetrySchedule:
    """Mutable per-call state: failed-attempt count + deadline clock.

    ``attempt`` is the number of failures noted so far: after the Nth
    ``note_failure`` it reads N.
    """

    __slots__ = ("policy", "attempt", "t0", "deadline_t", "_rng")

    def __init__(self, policy: RetryPolicy,
                 rng: Optional[random.Random] = None):
        self.policy = policy
        self.attempt = 0
        self.t0 = time.perf_counter()
        self.deadline_t = (self.t0 + policy.deadline
                           if policy.deadline is not None else None)
        self._rng = rng if rng is not None else random

    # -- clock queries --------------------------------------------------------
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def expired(self) -> bool:
        return (self.deadline_t is not None
                and time.perf_counter() >= self.deadline_t)

    def remaining(self, floor: float = 0.01,
                  default: Optional[float] = None) -> Optional[float]:
        """Seconds left on the deadline (never below ``floor``, so a
        just-expired schedule still gets a socket timeout that fails fast
        instead of a zero/negative one). ``default`` is returned when the
        schedule has no deadline — callers pass their static timeout."""
        if self.deadline_t is None:
            return default
        return max(self.deadline_t - time.perf_counter(), floor)

    # -- the decision ---------------------------------------------------------
    def note_failure(self) -> Tuple[str, float]:
        """Account one failed attempt and decide what happens next.

        Returns (RETRY, delay_seconds) when the caller should sleep and
        retry, (DEADLINE, 0.0) when the wall-clock budget is gone (checked
        first — a dead deadline wins over remaining retries), or
        (EXHAUSTED, 0.0) when the retry budget is spent. The delay is the
        jittered exponential backoff, capped at max_delay and clipped to
        whatever deadline remains."""
        self.attempt += 1
        now = time.perf_counter()
        if self.deadline_t is not None and now >= self.deadline_t:
            return DEADLINE, 0.0
        if self.attempt > self.policy.max_retries:
            return EXHAUSTED, 0.0
        delay = min(self.policy.backoff * (2 ** (self.attempt - 1)),
                    self.policy.max_delay)
        if self.policy.jitter:
            lo = 1.0 - self.policy.jitter
            delay *= lo + 2.0 * self.policy.jitter * self._rng.random()
        if self.deadline_t is not None:
            delay = min(delay, max(self.deadline_t - now, 0.0))
        return RETRY, delay

    def sleep_or_raise(self, exc_factory=None) -> None:
        """Convenience for plain loops: sleep the next backoff delay, or
        raise ``exc_factory(outcome, self)`` (default TimeoutError) when
        the schedule is done."""
        outcome, delay = self.note_failure()
        if outcome == RETRY:
            time.sleep(delay)
            return
        if exc_factory is not None:
            raise exc_factory(outcome, self)
        raise TimeoutError(
            f"retry schedule {outcome} after {self.attempt} attempts "
            f"({self.elapsed():.3f}s)")
