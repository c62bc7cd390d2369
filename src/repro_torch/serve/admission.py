"""Admission control: bounded queue + overload policy.

An open-loop arrival process does not slow down when the server falls
behind — past saturation the queue grows without bound and every
latency percentile diverges with the length of the run. Admission
control trades a little goodput for a bounded queue: the wait for any
*accepted* request is at most `queue_depth / service_rate`, so accepted
p99 stays flat past the saturation point while a no-admission baseline's
p99 climbs forever.

Three policies:

* ``"none"``   — accept everything; the unbounded baseline.
* ``"reject"`` — refuse new requests while the queue is at `queue_depth`
  (or the oldest queued request is older than `max_age_us`, when set).
  Refusals carry a `retry_after_us` hint: the estimated time to drain
  the current backlog at the server's measured per-request service rate
  — a cooperative client that waits that long will usually be admitted.
* ``"shed"``   — admit the new request but evict the *oldest* queued one
  (its waiting time is already the worst in the room; under overload it
  is the request most likely to be useless by the time it is served).

The controller is pure decision logic — no clocks, no locks, no queue of
its own. `SAServer` feeds it the observed queue state and applies the
decision; that keeps it unit-testable with plain numbers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

#: valid overload_policy spellings, in docs order
POLICIES = ("none", "reject", "shed")


@dataclass(frozen=True)
class AdmissionDecision:
    """What to do with one arriving request."""

    action: str                            # "accept" | "reject" | "shed"
    retry_after_us: Optional[float] = None  # set on "reject" only

    @property
    def accepted(self) -> bool:
        return self.action in ("accept", "shed")


class AdmissionController:
    """Apply one overload policy to a stream of (queue state) observations."""

    def __init__(self, *, queue_depth: int = 1024, policy: str = "reject",
                 max_age_us: Optional[float] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown overload policy {policy!r} "
                             f"(choose from {POLICIES})")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be ≥ 1, got {queue_depth}")
        self.queue_depth = int(queue_depth)
        self.policy = policy
        self.max_age_us = max_age_us

    def admit(self, queued: int, oldest_age_us: float,
              est_us_per_req: Optional[float] = None) -> AdmissionDecision:
        """Decide for one arrival given the queue's depth and oldest age.

        `est_us_per_req` is the server's measured per-request service cost
        (EMA); it prices the retry-after hint. Before any batch has
        completed there is no estimate and the hint falls back to the
        backlog count (1 µs/request floor) — deliberately optimistic, a
        cold server would rather see the retry early than late.
        """
        overloaded = queued >= self.queue_depth or (
            self.max_age_us is not None and oldest_age_us > self.max_age_us)
        if self.policy == "none" or not overloaded:
            return AdmissionDecision("accept")
        if self.policy == "shed":
            return AdmissionDecision("shed")
        per_req = est_us_per_req if est_us_per_req else 1.0
        return AdmissionDecision(
            "reject", retry_after_us=max(queued * per_req, 1.0))
