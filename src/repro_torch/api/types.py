"""Typed request/response envelope of the search facade and the serving engine."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.config import DynamicParams

PRIORITIES = ("interactive", "batch")


@dataclass(frozen=True)
class SearchRequest:
    """One sparse query: term ids + weights, optionally with a per-request
    ``DynamicParams`` override (k ≤ k_max, μ, η, β); None serves the defaults.

    Serving-policy fields, inert outside the engine: ``deadline_ms`` is a
    relative deadline (a request still queued when it expires fails with
    ``DeadlineExceeded`` and is never scored); ``tenant`` names the token
    bucket charged at admission; ``priority`` picks the queue lane
    (``interactive`` preempts ``batch``); ``request_id`` tags the request for
    error correlation (the engine assigns one when None)."""

    tids: np.ndarray  # int [n_terms]
    weights: np.ndarray  # float [n_terms]
    params: Optional[DynamicParams] = None
    deadline_ms: Optional[float] = None  # relative; None = no deadline
    tenant: Optional[str] = None  # admission quota bucket; None = anonymous
    priority: str = "interactive"  # 'interactive' | 'batch' queue lane
    request_id: Optional[str] = None  # caller-supplied correlation id

    def __post_init__(self) -> None:
        object.__setattr__(self, "tids", np.asarray(self.tids, np.int32))
        object.__setattr__(self, "weights", np.asarray(self.weights, np.float32))
        if self.tids.shape != self.weights.shape or self.tids.ndim != 1:
            raise ValueError(
                f"SearchRequest wants 1-D tids/weights of equal length, got "
                f"{self.tids.shape} and {self.weights.shape}"
            )
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0 (or None for no deadline), got {self.deadline_ms!r}")
        if self.priority not in PRIORITIES:
            raise ValueError(f"unknown priority {self.priority!r}; expected one of {PRIORITIES}")


@dataclass(frozen=True)
class SearchResponse:
    """Top-k documents of one request plus traversal and serving provenance.

    ``doc_ids``/``scores`` are [k] (the request's k), -1 / NEG where fewer
    than k documents survived. ``theta`` and the visit counters are None when
    the serving retriever does not report them. ``degraded`` is True when the
    SLO controller served the request below its point; ``params_served`` (the
    same object as ``params``) is the point scored."""

    doc_ids: np.ndarray  # int32 [k]
    scores: np.ndarray  # float32 [k]
    theta: Optional[float] = None  # round-0 pruning threshold
    n_superblocks_visited: Optional[int] = None
    n_blocks_scored: Optional[int] = None
    params: Optional[DynamicParams] = None  # the dynamic point served
    epoch: int = 0  # index epoch that produced this result
    cache_hit: bool = False  # served from the result cache?
    bucket: Optional[Tuple[int, int]] = None  # (batch, nq) shape that ran
    shard_candidates: Optional[np.ndarray] = field(default=None, repr=False)  # int32 [P] top-γ share per shard
    degraded: bool = False  # served below the requested/default point?
    params_served: Optional[DynamicParams] = None  # the point actually scored
    delta_seq: int = 0  # mutation sequence served (0 for an immutable index)

    @property
    def k(self) -> int:
        return int(self.doc_ids.shape[0])
