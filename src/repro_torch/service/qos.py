"""QoS classes and token-bucket admission for the block service.

A :class:`QosClass` bundles everything the dispatcher needs to treat a
tenant's traffic differently from its neighbours':

* ``priority``     -- strict inter-class dispatch order (0 is served first:
  latency-sensitive serve reads preempt throughput-oriented checkpoint
  writes at every dispatch decision);
* ``deadline_us``  -- optional earliest-deadline-first reordering *within*
  a priority level (requests carry ``t_submit + deadline_us`` as their EDF
  key; classes without a deadline fall back to arrival order);
* ``rate_iops``/``burst`` -- per-tenant token bucket: a tenant with an
  empty bucket is simply not eligible for dispatch until it refills, which
  shapes its throughput without dropping requests;
* ``queue_cap``    -- per-tenant submission-queue depth cap; arrivals past
  it are rejected at admission (the NVMe "queue full" path) so an
  open-loop aggressor cannot grow unbounded host-side state;
* ``max_inflight`` -- per-class cap on in-flight requests, carving the
  dispatcher's global window so one class can never occupy every slot.

Two canned classes cover the common split; scenarios are free to define
their own.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class QosClass:
    name: str
    priority: int = 1            # 0 = served first (strict priority)
    deadline_us: float = math.inf  # relative deadline; EDF within the class
    rate_iops: float = 0.0       # 0 => no token bucket
    burst: int = 16              # bucket depth (requests)
    queue_cap: int = 1024        # per-tenant submission-queue depth cap
    max_inflight: int = 0        # 0 => no per-class in-flight cap


# latency-sensitive foreground traffic (e.g. serving reads)
LATENCY = QosClass("latency", priority=0, deadline_us=1_500.0)
# throughput-oriented background streams (e.g. checkpoint writes)
THROUGHPUT = QosClass("throughput", priority=2)


class TokenBucket:
    """Classic token bucket on the virtual clock (tokens = requests)."""

    def __init__(self, rate_iops: float, burst: int, t0: float = 0.0):
        assert rate_iops > 0
        self.rate = rate_iops / 1e6          # tokens per virtual microsecond
        self.burst = float(max(1, burst))
        self.tokens = self.burst             # starts full
        self.t_last = t0

    def _refill(self, now: float) -> None:
        if now > self.t_last:
            self.tokens = min(self.burst, self.tokens + (now - self.t_last) * self.rate)
            self.t_last = now

    def peek(self, now: float) -> float:
        """Tokens available at ``now`` (no consumption)."""
        self._refill(now)
        return self.tokens

    def take(self, now: float) -> bool:
        """Consume one token if available."""
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def next_ready(self, now: float) -> float:
        """Earliest virtual time at which a full token will exist."""
        self._refill(now)
        if self.tokens >= 1.0:
            return now
        return now + (1.0 - self.tokens) / self.rate
