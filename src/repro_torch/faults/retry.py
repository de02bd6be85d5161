"""Bounded, jittered exponential backoff -- the one retry schedule (copy
of the reference's ``faults/retry.py``).

Every retry loop must have a bounded attempt count and a growing,
jittered sleep.  This module is the sanctioned way to write one:

    for delay in Backoff(attempts=5, base=0.1).delays():
        if try_thing():
            break
        time.sleep(delay)
    else:
        raise TimeoutError(...)

Jitter is multiplicative (up to ``jitter`` fractional extra) so a fleet
of ranks polling the same file does not phase-lock into thundering
herds; pass ``seed`` for a reproducible schedule in tests.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass(frozen=True)
class Backoff:
    """``attempts`` sleeps starting at ``base`` seconds, multiplied by
    ``factor`` each time, capped at ``cap``, each stretched by up to
    ``jitter`` fractional random extra."""

    attempts: int = 5
    base: float = 0.05
    factor: float = 2.0
    cap: float = 2.0
    jitter: float = 0.25
    seed: Optional[int] = None

    def delays(self) -> Iterator[float]:
        rng = random.Random(self.seed)
        d = self.base
        for _ in range(max(1, self.attempts)):
            yield min(d, self.cap) * (1.0 + self.jitter * rng.random())
            d *= self.factor

    def sleep_until(self, deadline: float) -> Iterator[float]:
        """Delays clipped to a ``time.monotonic()`` deadline: yields until
        the deadline passes, then stops (the caller raises its structured
        timeout).  The final sleep never overshoots the deadline, so a
        0.3 s commit timeout still polls more than once."""
        for d in self.delays():
            left = deadline - time.monotonic()
            if left <= 0:
                return
            yield min(d, left)

    def repolling(self) -> "Backoff":
        """An unbounded-attempts view for deadline-bounded loops (the
        bound is the deadline, enforced by ``sleep_until``)."""
        return Backoff(attempts=1 << 30, base=self.base, factor=self.factor,
                       cap=self.cap, jitter=self.jitter, seed=self.seed)


__all__ = ["Backoff"]
