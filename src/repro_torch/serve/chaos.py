"""Fault-injection harness for the serving layer.

Two injection points, composable:

* ``ChaosInjector`` — an *engine hook* (``RetrievalEngine(chaos=...)`` or
  ``set_chaos()`` on a live engine): the worker calls ``on_batch()`` right
  before scoring each batch, where the injector can stall (latency spike /
  jitter) or raise (transient fault). Because it fires inside the worker's
  failure-isolation boundary, an injected fault fails exactly that batch's
  futures and serving continues — the same path a real retriever exception
  takes.
* ``ChaosRetriever`` — a retriever wrapper for harnesses that construct their
  own retriever: identical injection schedule at the retriever boundary,
  forwarding ``supports_dynamic``/``defaults``/``warmup``/... so the wrapped
  retriever still advertises dynamic-params support.

Injection schedules are deterministic (every Nth batch, seeded jitter) so a
chaos run is reproducible. Swap-during-burst is not simulated here: harnesses
drive the real ``engine.swap_retriever``/``swap_index`` mid-burst.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np


class ChaosFault(RuntimeError):
    """A deliberately injected transient fault (distinguishable from real bugs)."""


@dataclass(frozen=True)
class ChaosConfig:
    fault_every: int = 0  # raise ChaosFault on every Nth batch; 0 = off
    spike_every: int = 0  # stall spike_ms on every Nth batch; 0 = off
    spike_ms: float = 50.0
    jitter_ms: float = 0.0  # uniform [0, jitter_ms) stall on every batch
    seed: int = 0

    def __post_init__(self) -> None:
        if self.fault_every < 0 or self.spike_every < 0:
            raise ValueError("fault_every/spike_every must be >= 0 (0 = off)")
        if self.spike_ms < 0 or self.jitter_ms < 0:
            raise ValueError("spike_ms/jitter_ms must be >= 0")


class ChaosInjector:
    """Deterministic injection schedule + counters; thread-safe."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self.batches = 0
        self.faults_injected = 0
        self.spikes_injected = 0
        self._rng = np.random.default_rng(cfg.seed)
        self._lock = threading.Lock()

    def on_batch(self, n_requests: int = 0) -> None:
        """Called by the engine worker before scoring a batch. May sleep
        (spike/jitter) and may raise ``ChaosFault`` (transient fault)."""
        with self._lock:
            self.batches += 1
            count = self.batches
            stall = 0.0
            if self.cfg.jitter_ms:
                stall += float(self._rng.uniform(0.0, self.cfg.jitter_ms))
            if self.cfg.spike_every and count % self.cfg.spike_every == 0:
                stall += self.cfg.spike_ms
                self.spikes_injected += 1
            fault = bool(self.cfg.fault_every and count % self.cfg.fault_every == 0)
            if fault:
                self.faults_injected += 1
        if stall:
            time.sleep(stall / 1e3)
        if fault:
            raise ChaosFault(f"injected transient fault (batch {count})")

    def summary(self) -> dict:
        with self._lock:
            return {
                "batches": self.batches,
                "faults_injected": self.faults_injected,
                "spikes_injected": self.spikes_injected,
            }


class ChaosRetriever:
    """Retriever-boundary injection: same schedule, applied around the inner
    call. Forwards every attribute (``supports_dynamic``, ``defaults``,
    ``static_cfg``, ``warmup``, ``n_traces``, ...) to the wrapped retriever."""

    def __init__(self, inner, cfg: ChaosConfig):
        self.inner = inner
        self.injector = ChaosInjector(cfg)

    def __call__(self, qb, dyn=None):
        self.injector.on_batch()
        if getattr(self.inner, "supports_dynamic", False):
            return self.inner(qb, dyn)
        return self.inner(qb)

    def __getattr__(self, name):
        return getattr(self.inner, name)
