"""Admission control front door: deadlines, tenant quotas, priority lanes
of the serving engine.

Ordering guarantee at the front door, per request:

1. **Quota** — the tenant's token bucket is charged first; an empty bucket
   raises ``AdmissionRejected`` synchronously (no queue slot, no future).
2. **Deadline** — the request's ``deadline_ms`` (or the config default) is
   turned into an absolute expiry; a request whose deadline expires while
   queued or while blocked on backpressure is failed fast with
   ``DeadlineExceeded`` and is *never scored*.
3. **Lane** — admitted requests go to one of two lanes over the bounded
   queue: ``interactive`` (drained first, always) or ``batch`` (drained only
   when no interactive work is waiting). Within a lane, FIFO order holds;
   across lanes, interactive preempts at every collect step, so a batch
   backlog cannot add queueing delay to interactive traffic.

Token buckets refill continuously at ``rate`` tokens/s up to ``burst``; one
request costs one token. Unknown tenants (and ``tenant=None``) fall to
``default_quota`` — ``None`` there means unlimited, so an engine with no
admission config behaves exactly like the pre-admission engine.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.api.types import PRIORITIES
from repro_torch.serve.errors import AdmissionRejected

LANE_INTERACTIVE = 0
LANE_BATCH = 1


@dataclass(frozen=True)
class TenantQuota:
    """Token-bucket parameters: sustained ``rate`` requests/s, ``burst`` capacity."""

    rate: float
    burst: float = 0.0  # 0 -> rate (a 1-second burst)

    def __post_init__(self) -> None:
        if self.rate <= 0:
            raise ValueError(f"quota rate must be > 0 req/s, got {self.rate!r}")
        if self.burst < 0:
            raise ValueError(f"quota burst must be >= 0 (0 = rate), got {self.burst!r}")


class TokenBucket:
    """Thread-safe continuous-refill token bucket. Starts full."""

    def __init__(self, quota: TenantQuota, clock=time.monotonic):
        self.rate = quota.rate
        self.capacity = quota.burst or quota.rate
        self._tokens = self.capacity
        self._last = clock()
        self._clock = clock
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> bool:
        now = self._clock()
        with self._lock:
            self._tokens = min(self.capacity, self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


@dataclass(frozen=True)
class AdmissionConfig:
    """Front-door policy. Everything defaults to 'off': no deadlines, no
    quotas — an ``AdmissionConfig()`` engine admits exactly what the
    pre-admission engine did."""

    default_deadline_ms: float = 0.0  # applied when a request carries none; 0 = none
    quotas: Dict[str, TenantQuota] = field(default_factory=dict)  # per-tenant buckets
    default_quota: Optional[TenantQuota] = None  # unlisted tenants; None = unlimited

    def __post_init__(self) -> None:
        if self.default_deadline_ms < 0:
            raise ValueError(
                f"default_deadline_ms must be >= 0 (0 = no deadline), "
                f"got {self.default_deadline_ms!r}"
            )


class AdmissionController:
    """Charges quotas and computes expiries; owned by the engine, called on
    caller threads (so rejects cost the worker nothing)."""

    def __init__(self, cfg: AdmissionConfig, clock=time.monotonic):
        self.cfg = cfg
        self._clock = clock
        self._buckets: Dict[Optional[str], TokenBucket] = {}
        self._lock = threading.Lock()

    def _bucket(self, tenant: Optional[str]) -> Optional[TokenBucket]:
        quota = self.cfg.quotas.get(tenant) if tenant is not None else None
        if quota is None:
            quota = self.cfg.default_quota
            if quota is None:
                return None
        # each tenant gets its own bucket, even when served by the default quota
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                b = self._buckets[tenant] = TokenBucket(quota, clock=self._clock)
            return b

    def admit(self, tenant: Optional[str], request_id: str) -> None:
        """Charge the tenant's bucket; raise ``AdmissionRejected`` when empty."""
        b = self._bucket(tenant)
        if b is not None and not b.try_acquire():
            raise AdmissionRejected(
                f"tenant {tenant!r} is over quota ({b.rate:g} req/s, burst {b.capacity:g}); "
                f"request {request_id} rejected at admission",
                request_id=request_id,
                tenant=tenant,
            )

    def expiry(self, deadline_ms: Optional[float], t0: float) -> Optional[float]:
        """Absolute monotonic expiry for this request, or None (no deadline)."""
        d = deadline_ms if deadline_ms is not None else (self.cfg.default_deadline_ms or None)
        return None if d is None else t0 + d / 1e3

    @staticmethod
    def lane(priority: str) -> int:
        if priority not in PRIORITIES:
            raise ValueError(f"unknown priority {priority!r}; expected one of {PRIORITIES}")
        return LANE_INTERACTIVE if priority == "interactive" else LANE_BATCH
