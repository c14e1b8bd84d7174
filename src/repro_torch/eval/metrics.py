"""Retrieval quality metrics (host numpy)."""

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
