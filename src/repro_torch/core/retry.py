"""RetryPolicy: one seeded backoff schedule for every retry loop.

Before this module, each subsystem retried its own way: the file engine
re-queued a failed chunk immediately (hammering a degraded link with the
exact traffic that just failed), the healing transfer replanned with no
pause between reroutes, and there was no liveness probing at all.  The
paper's guidance is the opposite — back off a misbehaving path and let
the autotuner re-fit — so all retry behavior now routes through one
policy object: seeded exponential backoff with deterministic jitter, a
modeled-seconds deadline, and a max attempt count.

Determinism: delays are *modeled* seconds derived from the LCG in
``repro_torch.core.autotune`` — nothing here reads a wall clock (mpwlint R5),
so a chaos run replays the same schedule twice.  Callers that sleep for
real (none in ``core/``) convert the modeled delay themselves.

mpwlint rule **R6** enforces adoption: a literal ``while``-retry in
``src/`` (a ``continue`` inside an ``except`` handler, or a
``time.sleep`` next to a ``try`` in the loop body) must reference a
``RetryPolicy`` in its enclosing function.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

from repro_torch.core.autotune import _lcg01


@dataclass(frozen=True)
class RetryPolicy:
    """Seeded exponential backoff + jitter + deadline + attempt cap.

    `max_attempts` counts *tries*, not retries: 1 means "try once, never
    retry".  The delay before retry k (the k+1-th try, k >= 1) is
    ``base_s * multiplier**(k-1)`` clamped to `max_s`, scaled by a
    deterministic jitter factor in ``[1-jitter/2, 1+jitter/2)`` drawn
    from the LCG on ``(seed, key, k)`` — two runs with the same seed see
    the same schedule, two chunks (different `key`) see decorrelated
    ones.  `deadline_s` caps the *cumulative modeled delay*: a schedule
    stops yielding once the next delay would exceed it.
    """
    max_attempts: int = 4
    base_s: float = 0.05
    multiplier: float = 2.0
    max_s: float = 5.0
    jitter: float = 0.5
    deadline_s: float = float("inf")
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(
                f"RetryPolicy.max_attempts must be >= 1, got {self.max_attempts}")
        if self.multiplier < 1.0:
            raise ValueError(
                f"RetryPolicy.multiplier must be >= 1, got {self.multiplier}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(
                f"RetryPolicy.jitter must be in [0, 1], got {self.jitter}")

    def delay_s(self, attempt: int, key: int = 0) -> float:
        """Modeled backoff before try `attempt` (0-based; try 0 is free)."""
        if attempt <= 0:
            return 0.0
        raw = min(self.max_s, self.base_s * self.multiplier ** (attempt - 1))
        u = _lcg01(self.seed * 1000003 + key * 8191 + attempt)
        return raw * (1.0 + self.jitter * (u - 0.5))

    def schedule(self, key: int = 0) -> Iterator[float]:
        """Yield the modeled delay before each try: 0.0, d1, d2, ...

        Stops after `max_attempts` tries or when cumulative delay would
        blow `deadline_s` — ``for delay in policy.schedule(key): ...``
        is the canonical retry loop (and what R6 looks for).
        """
        spent = 0.0
        for attempt in range(self.max_attempts):
            d = self.delay_s(attempt, key)
            if spent + d > self.deadline_s:
                return
            spent += d
            yield d

    def total_budget_s(self, key: int = 0) -> float:
        """Cumulative modeled delay of a full schedule (for lease math)."""
        return sum(self.schedule(key))

    def with_(self, **kw) -> "RetryPolicy":
        from dataclasses import replace
        return replace(self, **kw)


class RetryState:
    """Mutable cursor over one policy schedule (for loops that cannot be
    written as a ``for``: the Trainer's fault-recovery loop interleaves
    successful steps between retries, so exhaustion is judged per
    *incident streak*, not per loop entry)."""

    def __init__(self, policy: RetryPolicy, key: int = 0) -> None:
        self.policy = policy
        self.key = key
        self.attempt = 0
        self.spent_s = 0.0

    def next_delay_s(self) -> Optional[float]:
        """Modeled delay before the next retry, or None when exhausted."""
        nxt = self.attempt + 1
        if nxt >= self.policy.max_attempts:
            return None
        d = self.policy.delay_s(nxt, self.key)
        if self.spent_s + d > self.policy.deadline_s:
            return None
        self.attempt = nxt
        self.spent_s += d
        return d

    def reset(self) -> None:
        """A success ends the incident streak: the next fault starts the
        schedule over."""
        self.attempt = 0
        self.spent_s = 0.0


# membership liveness probes share one conservative default: a couple of
# quick re-probes (a transient blip should not cost a lease) before the
# monitor lets the lease clock run out
PROBE_RETRY = RetryPolicy(max_attempts=3, base_s=0.1, multiplier=2.0,
                          max_s=2.0, jitter=0.5)

# KV-cache ships race a request deadline, so the backoff ladder is shorter
# and tighter than the probe default: fail fast toward the reroute path
# (`max_reships` in core/serving.py) instead of waiting out a dead link
KVSHIP_RETRY = RetryPolicy(max_attempts=4, base_s=0.05, multiplier=2.0,
                           max_s=1.0, jitter=0.5)
