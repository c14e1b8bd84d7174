"""Canonical three-way merge: main-index results + delta segment - tombstones.

The mutable-index search path scores two streams per query, the pruned
main-index top-k (already in canonical order) and the exactly scored delta
segment, and combines them under the same total order every other pipeline
uses: score descending, external doc id ascending (``core.topk.canonical_topk``).
This module is the host-side mirror of that order: two stable numpy argsorts
(id ascending, then score descending) compose to exactly the canonical order.
It runs on the host in numpy, as in the JAX package, with the same bits.

Tombstones are masked *before* the merge (score ``NEG``, id -1), never after:
a tombstoned doc must not displace a live one from the k-wide window.

θ over the combined stream is ``max(θ_main, k-th best delta score)``. Both
are lower bounds on the true k-th live score: θ_main because the main
traversal overfetched ``k_eff = k + |tombstones|`` lanes, the delta k-th
because adding the main stream can only raise the combined k-th. With fewer
than k live delta docs the delta operand is ``NEG`` and the merged θ is
exactly θ_main, which makes an empty delta a bit-exact passthrough of the
immutable pipeline.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.scoring import NEG


def canonical_order_rows(scores: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Per-row argsort of [Q, N] candidates into canonical (score desc, id asc)
    order. Two stable sorts: id-ascending first, then score-descending, which
    keeps the first's order among equal scores."""
    by_id = np.argsort(ids, axis=1, kind="stable")
    s = np.take_along_axis(scores, by_id, axis=1)
    by_score = np.argsort(-s, axis=1, kind="stable")
    return np.take_along_axis(by_id, by_score, axis=1)


def delta_kth_scores(delta_scores: np.ndarray, k_rows: np.ndarray, k_max: int) -> np.ndarray:
    """Per-row k-th best delta score [Q], or ``NEG`` where the delta stream has
    fewer than k live docs: the delta operand of the merged θ."""
    q = delta_scores.shape[0]
    pad = np.full((q, k_max), np.float32(NEG), np.float32)
    padded = np.concatenate([delta_scores.astype(np.float32), pad], axis=1)
    desc = -np.sort(-padded, axis=1)
    return desc[np.arange(q), np.clip(k_rows - 1, 0, desc.shape[1] - 1)]


def merge_mutable_topk(
    main_ids: np.ndarray,
    main_scores: np.ndarray,
    delta_ids: np.ndarray,
    delta_scores: np.ndarray,
    k_rows: np.ndarray,
    k_max: int,
    theta_main: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge tombstone-masked main results [Q, Km] with exactly scored delta
    docs (ids [D], scores [Q, D], tombstoned entries already (-1, NEG)) into
    the canonical top-``k_max`` window, masked at each row's dynamic ``k`` as
    ``core.lsp.mask_beyond_k`` does. Returns (ids [Q, k_max] int32, scores
    [Q, k_max] float32, theta [Q] float32)."""
    q = main_ids.shape[0]
    neg = np.float32(NEG)
    d_ids = np.broadcast_to(delta_ids[None, :], (q, delta_ids.shape[0]))
    cand_ids = np.concatenate([main_ids, d_ids], axis=1).astype(np.int64)
    cand_scores = np.concatenate([main_scores.astype(np.float32), delta_scores.astype(np.float32)], axis=1)
    order = canonical_order_rows(cand_scores, cand_ids)[:, :k_max]
    top_ids = np.take_along_axis(cand_ids, order, axis=1)
    top_scores = np.take_along_axis(cand_scores, order, axis=1)
    if top_ids.shape[1] < k_max:  # fewer candidates than the window: pad
        pad_n = k_max - top_ids.shape[1]
        top_ids = np.concatenate([top_ids, np.full((q, pad_n), -1, np.int64)], axis=1)
        top_scores = np.concatenate([top_scores, np.full((q, pad_n), neg, np.float32)], axis=1)
    valid = (top_scores > NEG / 2) & (np.arange(k_max)[None, :] < k_rows[:, None])
    out_ids = np.where(valid, top_ids, -1).astype(np.int32)
    out_scores = np.where(valid, top_scores, neg).astype(np.float32)
    theta = np.maximum(theta_main.astype(np.float32), delta_kth_scores(delta_scores, k_rows, k_max)).astype(np.float32)
    return out_ids, out_scores, theta
