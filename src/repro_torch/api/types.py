"""Typed request/response envelope of the search facade."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.config import DynamicParams


@dataclass(frozen=True)
class SearchRequest:
    """One sparse query: term ids + weights, optionally with a per-request
    ``DynamicParams`` override (k ≤ k_max, μ, η, β); None serves the defaults."""

    tids: np.ndarray  # int [n_terms]
    weights: np.ndarray  # float [n_terms]
    params: Optional[DynamicParams] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "tids", np.asarray(self.tids, np.int32))
        object.__setattr__(self, "weights", np.asarray(self.weights, np.float32))
        if self.tids.shape != self.weights.shape or self.tids.ndim != 1:
            raise ValueError(
                f"SearchRequest wants 1-D tids/weights of equal length, got "
                f"{self.tids.shape} and {self.weights.shape}"
            )


@dataclass(frozen=True)
class SearchResponse:
    """Top-k documents of one request plus traversal provenance.

    ``doc_ids``/``scores`` are [k] (the request's k), -1 / NEG where fewer
    than k documents survived."""

    doc_ids: np.ndarray  # int32 [k]
    scores: np.ndarray  # float32 [k]
    theta: Optional[float] = None  # round-0 pruning threshold
    n_superblocks_visited: Optional[int] = None
    n_blocks_scored: Optional[int] = None
    params: Optional[DynamicParams] = None  # the dynamic point served
    bucket: Optional[Tuple[int, int]] = None  # (batch, nq) shape that ran

    @property
    def k(self) -> int:
        return int(self.doc_ids.shape[0])
