"""SLO feedback controller: adaptive degradation under overload.

Relevance degrades gracefully along the (k, μ, η, β) axis, and the
static/dynamic split makes that axis free per request. This module is a
feedback controller that watches
queue depth and the windowed p99 of *served* requests and, under pressure,
walks the effective ``DynamicParams`` down a validated degradation ladder
(zero-shot point → tighter η/μ → capped query terms → smaller k), recovering
with hysteresis once pressure clears.

State machine (one integer ``level`` indexing the ladder):

    pressure   := queue_depth >= queue_high * capacity  OR  window_p99 > p99_ms
    degrade    :  pressure for one decision interval        -> level += 1
    recover    :  ``recover_after`` consecutive healthy intervals AND
                  window_p99 < recover_margin * p99_ms      -> level -= 1

Decisions are rate-limited to one per ``interval_ms`` and the recovery path is
deliberately slower than the degrade path (hysteresis): a burst degrades the
engine in one interval, but it climbs back one rung per ``recover_after``
healthy intervals, so an oscillating load does not flap the ladder.

The controller never touches shapes: rung params ride the batch as per-row
tensors, and the per-rung ``nq_cap`` only changes which existing nq bucket a
query selects.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.config import (
    DegradationRung,
    DynamicParams,
    StaticConfig,
    validate_degradation_ladder,
)


def default_degradation_ladder(
    defaults: Optional[DynamicParams] = None, nq_max: int = 64
) -> tuple[DegradationRung, ...]:
    """The stock 4-rung ladder: the serving defaults (rung 0, no degradation),
    tighter μ/η, a query-term cap riding a smaller nq bucket, and finally a
    smaller k. Bounds are compared against θ/μ and θ/η, so *smaller* μ/η prune
    more; every rung is strictly cheaper than the one above it."""
    d = defaults or DynamicParams()
    cap = max(16, nq_max // 4)
    return validate_degradation_ladder(
        [
            DegradationRung(d),
            DegradationRung(DynamicParams(k=d.k, mu=0.6 * d.mu, eta=0.6 * d.eta, beta=d.beta)),
            DegradationRung(
                DynamicParams(k=d.k, mu=0.5 * d.mu, eta=0.5 * d.eta, beta=min(d.beta, 0.25)),
                nq_cap=cap,
            ),
            DegradationRung(
                DynamicParams(
                    k=max(1, d.k // 2), mu=0.4 * d.mu, eta=0.4 * d.eta, beta=min(d.beta, 0.2)
                ),
                nq_cap=min(cap, 16),
            ),
        ]
    )


@dataclass(frozen=True)
class SLOConfig:
    """Targets and gains of the feedback controller. ``ladder=None`` means the
    stock ``default_degradation_ladder`` built from the engine's defaults."""

    p99_ms: float = 50.0  # the SLO: windowed p99 of served requests
    ladder: Optional[Sequence] = None  # DynamicParams / DegradationRung rungs; None = stock
    queue_high: float = 0.5  # queue fill fraction that signals pressure
    recover_margin: float = 0.8  # recover only while p99 < margin * target
    interval_ms: float = 25.0  # min time between controller decisions
    recover_after: int = 4  # consecutive healthy intervals per recovery step (hysteresis)
    window: int = 128  # served-latency samples the controller's p99 is over

    def __post_init__(self) -> None:
        if self.p99_ms <= 0:
            raise ValueError(f"p99_ms (the SLO target) must be > 0, got {self.p99_ms!r}")
        if not 0.0 < self.queue_high <= 1.0:
            raise ValueError(f"queue_high must be in (0, 1], got {self.queue_high!r}")
        if not 0.0 < self.recover_margin <= 1.0:
            raise ValueError(f"recover_margin must be in (0, 1], got {self.recover_margin!r}")
        if self.recover_after < 1:
            raise ValueError(f"recover_after must be >= 1, got {self.recover_after!r}")


@dataclass
class _ControllerState:
    level: int = 0
    healthy_streak: int = 0
    last_decision: float = 0.0
    degrade_steps: int = 0
    recover_steps: int = 0


class SLOController:
    """Thread-safe; shared by the engine's caller threads (admission-time
    ``resolve``/``observe``) and the worker (``record``/``observe``)."""

    def __init__(
        self,
        cfg: SLOConfig,
        queue_capacity: int,
        defaults: Optional[DynamicParams] = None,
        nq_max: int = 64,
        static: Optional[StaticConfig] = None,
        clock=time.monotonic,
    ):
        self.cfg = cfg
        self.queue_capacity = max(1, queue_capacity)
        self.ladder = (
            validate_degradation_ladder(cfg.ladder, static)
            if cfg.ladder is not None
            else default_degradation_ladder(defaults, nq_max)
        )
        self._clock = clock
        self._lat = deque(maxlen=cfg.window)
        self._state = _ControllerState()
        self._lock = threading.Lock()

    # ---- observations ----------------------------------------------------------

    @property
    def level(self) -> int:
        with self._lock:
            return self._state.level

    def record(self, latency_ms: float) -> None:
        """Feed one *served* latency sample (rejections never enter the window)."""
        with self._lock:
            self._lat.append(latency_ms)

    def window_p99(self) -> float:
        with self._lock:
            lat = np.asarray(self._lat, np.float64)
        return float(np.percentile(lat, 99)) if lat.size else 0.0

    def observe(self, queue_depth: int, now: Optional[float] = None) -> int:
        """One control decision (rate-limited to ``interval_ms``); returns the
        (possibly updated) ladder level."""
        now = self._clock() if now is None else now
        with self._lock:
            st = self._state
            if (now - st.last_decision) * 1e3 < self.cfg.interval_ms:
                return st.level
            st.last_decision = now
            lat = np.asarray(self._lat, np.float64)
            p99 = float(np.percentile(lat, 99)) if lat.size else 0.0
            pressure = (
                queue_depth >= self.cfg.queue_high * self.queue_capacity
                or p99 > self.cfg.p99_ms
            )
            if pressure:
                st.healthy_streak = 0
                if st.level < len(self.ladder) - 1:
                    st.level += 1
                    st.degrade_steps += 1
            else:
                st.healthy_streak += 1
                if (
                    st.level > 0
                    and st.healthy_streak >= self.cfg.recover_after
                    and p99 < self.cfg.recover_margin * self.cfg.p99_ms
                ):
                    st.level -= 1
                    st.recover_steps += 1
                    st.healthy_streak = 0  # each recovery step needs its own streak
            return st.level

    # ---- per-request resolution ------------------------------------------------

    def resolve(
        self, requested: Optional[DynamicParams], default: DynamicParams
    ) -> tuple[Optional[DynamicParams], bool, int]:
        """(effective params, degraded?, nq_cap) for one request at the current
        level. At level 0 the request is untouched. Under degradation the rung
        is combined with the requested point by taking the *cheaper* value on
        every axis (min — smaller k/μ/η/β all prune more), so a client that
        already asked for less than the rung is never upgraded."""
        with self._lock:
            level = self._state.level
        rung = self.ladder[level]
        if level == 0:
            return requested, False, rung.nq_cap
        base = requested or default
        p = rung.params
        eff = DynamicParams(
            k=min(base.k, p.k),
            mu=min(base.mu, p.mu),
            eta=min(base.eta, p.eta),
            beta=min(base.beta, p.beta),
        )
        return eff, True, rung.nq_cap

    def snapshot(self) -> dict:
        with self._lock:
            st = self._state
            lat = np.asarray(self._lat, np.float64)
            return {
                "level": st.level,
                "rungs": len(self.ladder),
                "window_p99_ms": float(np.percentile(lat, 99)) if lat.size else 0.0,
                "p99_target_ms": self.cfg.p99_ms,
                "degrade_steps": st.degrade_steps,
                "recover_steps": st.recover_steps,
            }

    def __repr__(self) -> str:
        return (
            f"SLOController(level={self.level}/{len(self.ladder) - 1}, "
            f"p99_target={self.cfg.p99_ms}ms, window_p99={self.window_p99():.1f}ms)"
        )
