"""Query-side preparation: padding, β term pruning, dense scatter."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class QueryBatch(NamedTuple):
    """Padded batch of sparse queries. Sentinel term id == vocab, weight == 0."""

    tids: torch.Tensor  # int32 [Q, nq_max]
    ws: torch.Tensor  # float32 [Q, nq_max]
    vocab: int

    @property
    def nq_max(self) -> int:
        return self.tids.shape[1]


def canonical_query(tids, ws, nq_max: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic (tids, ws) order: weight descending, term id breaking ties,
    so identical term/weight multisets always truncate and batch identically."""
    t = np.asarray(tids, np.int32)
    w = np.asarray(ws, np.float32)
    order = np.lexsort((t, -w))
    if nq_max:
        order = order[:nq_max]
    return t[order], w[order]


def query_key(tids, ws, nq_max: int = 0) -> bytes:
    """Hashable cache key: byte image of the canonical pruned (tids, ws) vectors."""
    t, w = canonical_query(tids, ws, nq_max)
    return t.tobytes() + w.tobytes()


def make_query_batch(queries, vocab: int, nq_max: int = 0, device=None) -> QueryBatch:
    """queries: list of (tids, weights) -> a QueryBatch on ``device`` (CUDA by
    default), rows in canonical order (so β pruning keeps a prefix). nq_max=0
    pads to the longest query rounded up to a multiple of 8."""
    device = resolve_device(device)
    if not nq_max:
        nq_max = max((len(t) for t, _ in queries), default=1)
        nq_max = max(8, -(-nq_max // 8) * 8)
    q = len(queries)
    tids = np.full((q, nq_max), vocab, np.int32)
    ws = np.zeros((q, nq_max), np.float32)
    for i, (t, w) in enumerate(queries):
        ct, cw = canonical_query(t, w, nq_max)
        tids[i, : len(ct)] = ct
        ws[i, : len(cw)] = cw
    return QueryBatch(torch.from_numpy(tids).to(device), torch.from_numpy(ws).to(device), vocab)


def prune_terms(qb: QueryBatch, beta: torch.Tensor) -> QueryBatch:
    """Keep each row's highest-weighted ceil(β_i · n_terms_i) terms; the rest
    become the sentinel (tid == vocab, weight 0). ``beta`` is float32 [Q].
    Used for candidate generation only: scoring uses the full query."""
    n_valid = (qb.tids < qb.vocab).sum(dim=1, keepdim=True)
    keep_n = torch.ceil(beta[:, None] * n_valid).to(torch.int32)
    keep = torch.arange(qb.nq_max, device=qb.tids.device)[None, :] < keep_n
    return QueryBatch(
        torch.where(keep, qb.tids, qb.vocab),
        torch.where(keep, qb.ws, 0.0),
        qb.vocab,
    )


def scatter_dense(qb: QueryBatch) -> torch.Tensor:
    """float32 [Q, vocab+1] dense query vectors; duplicate term ids add up and
    the sentinel column (== vocab) stays 0.

    Out-of-range ids follow ``jnp``'s ``.at[].add``: an id in [-(vocab+1), -1]
    wraps once (adds vocab+1), any other id outside [0, vocab] adds nothing.
    They are masked and clamped on the device, so no index that reaches
    ``scatter_add_`` is ever out of range (on CUDA one would be a device-side
    assert, which leaves the process's CUDA context unusable)."""
    q = qb.tids.shape[0]
    width = qb.vocab + 1
    tids = qb.tids.long()
    tids = torch.where(tids < 0, tids + width, tids)
    ok = (tids >= 0) & (tids < width)
    dense = torch.zeros((q, width), dtype=torch.float32, device=qb.tids.device)
    dense.scatter_add_(1, torch.where(ok, tids, qb.vocab), torch.where(ok, qb.ws, 0.0))
    dense[:, qb.vocab] = 0.0
    return dense
