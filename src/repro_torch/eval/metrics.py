"""Retrieval quality metrics (host numpy): recall@k against a rank-safe
oracle, MRR, and the failed and partial query shares."""

from __future__ import annotations

import numpy as np


def recall_vs_oracle(pred_ids: np.ndarray, oracle_ids: np.ndarray) -> float:
    """Mean fraction of the oracle top-k found by the approximate run
    (queries whose oracle list is empty are skipped)."""
    rs = []
    for p, o in zip(np.asarray(pred_ids), np.asarray(oracle_ids)):
        o = o[o >= 0]
        if len(o) == 0:
            continue
        rs.append(len(np.intersect1d(p[p >= 0], o)) / len(o))
    return float(np.mean(rs)) if rs else 0.0


def mrr_at_k(pred_ids: np.ndarray, relevant: np.ndarray, k: int = 10) -> float:
    """relevant: [Q] single relevant doc id per query (oracle top-1 in benchmarks)."""
    out = []
    for p, r in zip(np.asarray(pred_ids)[:, :k], np.asarray(relevant)):
        hit = np.flatnonzero(p == r)
        out.append(1.0 / (hit[0] + 1) if len(hit) else 0.0)
    return float(np.mean(out))


def failed_queries(pred_ids: np.ndarray) -> float:
    """Fraction of queries with zero results (the paper's erroneous-pruning metric)."""
    p = np.asarray(pred_ids)
    return float(np.mean((p < 0).all(axis=1)))


def partial_queries(pred_ids: np.ndarray) -> float:
    """Fraction producing some but fewer than k results."""
    p = np.asarray(pred_ids)
    some = (p >= 0).any(axis=1)
    full = (p >= 0).all(axis=1)
    return float(np.mean(some & ~full))
