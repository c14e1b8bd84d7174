"""Typed serving errors.

Every way the engine can fail a future has its own type, so a client can tell
shed load from crashes without string-matching:

* ``EngineShutdown``     — the engine stopped before serving the request; the
                           request was dropped, not computed wrong. Carries
                           the request id.
* ``DeadlineExceeded``   — the request's deadline expired while it was queued
                           (or blocked on backpressure); it was never scored.
                           Also a ``TimeoutError``.
* ``AdmissionRejected``  — the per-tenant token-bucket quota refused the
                           request; raised synchronously from ``search()``,
                           no queue slot was used.
* ``ShardGroupError``    — a rank of the process group that holds the shard
                           set failed or went silent (``serve/group.py``);
                           the request was not served, and no later one is.

All four subclass ``ServeError`` (a ``RuntimeError``), so callers catching
``RuntimeError`` keep working.
"""

from __future__ import annotations

from typing import Optional


class ServeError(RuntimeError):
    """Base of every typed serving-layer error."""

    def __init__(self, msg: str, request_id: Optional[str] = None):
        super().__init__(msg)
        self.request_id = request_id


class EngineShutdown(ServeError):
    """The engine shut down before serving this request (shed load, not a crash)."""


class DeadlineExceeded(ServeError, TimeoutError):
    """The request's deadline expired while queued; it was never scored."""

    def __init__(self, msg: str, request_id: Optional[str] = None, deadline_ms: Optional[float] = None):
        super().__init__(msg, request_id)
        self.deadline_ms = deadline_ms


class AdmissionRejected(ServeError):
    """The per-tenant quota refused this request at the front door."""

    def __init__(self, msg: str, request_id: Optional[str] = None, tenant: Optional[str] = None):
        super().__init__(msg, request_id)
        self.tenant = tenant


class ShardGroupError(ServeError):
    """The process group serving the shard set failed: a rank died, raised or
    missed a collective's timeout. Every request the group front end holds
    fails with it."""
