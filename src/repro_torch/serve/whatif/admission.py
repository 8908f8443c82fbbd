"""Token-bucket admission + bounded queue for the what-if front door
(port of ``repro.serve.whatif.admission``: pure Python, the reference's
code, with the same outcomes on the same clock).

The paper's subject is injection throttling inside the fabric; this
module applies the same discipline to the simulator-as-a-service front
door (the SNIPPETS.md throttling pattern, dogfooded): a per-tenant
token bucket meters the *rate* (with a burst allowance), a bounded
queue meters the *backlog*, and both reject explicitly — callers get a
:class:`Throttled` (with ``retry_after``) or :class:`QueueFull` outcome
instead of blocking forever or growing an unbounded queue.  Decisions
never silently drop work: every submitted query resolves to exactly one
of ``Admitted`` / ``Throttled`` / ``QueueFull``.

The clock is injected (``clock=time.monotonic`` by default) so tests
and replays drive admission deterministically.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Front-door policy: rate x burst per tenant, bounded backlog.

    ``rate`` tokens/second refill each tenant's bucket up to ``burst``;
    a query costs one token.  ``max_queue`` bounds the waiting queries
    across all tenants; ``max_inflight`` caps how many admitted queries
    may execute concurrently (the micro-batcher never builds a wider
    batch, whatever ``EngineConfig.max_batch`` says).
    """

    rate: float = 100.0
    burst: int = 32
    max_queue: int = 64
    max_inflight: int = 16

    def __post_init__(self):
        if self.rate < 0 or self.burst < 1:
            raise ValueError(
                f"rate must be >= 0 and burst >= 1, got rate={self.rate} "
                f"burst={self.burst}")
        if self.max_queue < 1 or self.max_inflight < 1:
            raise ValueError(
                f"max_queue and max_inflight must be >= 1, got "
                f"max_queue={self.max_queue} "
                f"max_inflight={self.max_inflight}")


# -- outcomes ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Admitted:
    """Query accepted; ``ticket`` keys the eventual result."""

    ticket: int
    tenant: str = "default"
    queue_depth: int = 0


@dataclasses.dataclass(frozen=True)
class Throttled:
    """Over-rate: the tenant's token bucket is empty.  Retry after
    ``retry_after`` seconds (when the next token lands)."""

    tenant: str
    retry_after: float


@dataclasses.dataclass(frozen=True)
class QueueFull:
    """Back-pressure: the bounded queue is at capacity.  The token was
    *not* consumed; retry after the service drains."""

    tenant: str
    queue_depth: int


# -- token bucket -----------------------------------------------------------


class TokenBucket:
    """Continuous-refill token bucket (rate/s up to ``burst``)."""

    def __init__(self, rate: float, burst: int, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)          # start full: bursts admit
        self.stamp = now

    def _refill(self, now: float) -> None:
        if now > self.stamp:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.stamp) * self.rate)
        self.stamp = max(self.stamp, now)

    def peek(self, now: float) -> bool:
        self._refill(now)
        return self.tokens >= 1.0

    def take(self, now: float) -> bool:
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def retry_after(self, now: float) -> float:
        """Seconds until a full token is available (inf at rate 0)."""
        self._refill(now)
        if self.tokens >= 1.0:
            return 0.0
        if self.rate <= 0.0:
            return float("inf")
        return (1.0 - self.tokens) / self.rate


class AdmissionController:
    """Per-tenant token buckets + counters; the engine owns the queue.

    ``admit(tenant)`` charges the tenant's bucket (created on first
    sight, starting full) and returns ``None`` on success or a
    :class:`Throttled` outcome.  Queue capacity is checked *before*
    the token is spent — a rejected query never burns budget.
    """

    def __init__(self, cfg: AdmissionConfig,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self._buckets: dict[str, TokenBucket] = {}
        self.admitted = 0
        self.throttled = 0
        self.queue_full = 0

    def _bucket(self, tenant: str) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = TokenBucket(
                self.cfg.rate, self.cfg.burst, self.clock())
        return b

    def admit(self, tenant: str, queue_depth: int):
        """None = admitted (token charged); else Throttled/QueueFull."""
        now = self.clock()
        bucket = self._bucket(tenant)
        if not bucket.peek(now):
            self.throttled += 1
            return Throttled(tenant=tenant,
                             retry_after=bucket.retry_after(now))
        if queue_depth >= self.cfg.max_queue:
            self.queue_full += 1
            return QueueFull(tenant=tenant, queue_depth=queue_depth)
        bucket.take(now)
        self.admitted += 1
        return None

    def counters(self) -> dict:
        return {"admitted": self.admitted, "throttled": self.throttled,
                "queue_full": self.queue_full,
                "tenants": len(self._buckets)}
