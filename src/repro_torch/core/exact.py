"""Rank-safe exhaustive scoring: the recall oracle, and the exact host-side
scores of a mutable index's delta segment."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.query import QueryBatch, scatter_dense
from repro_torch.core.scoring import NEG, score_positions_fwd
from repro_torch.core.topk import canonical_topk
from repro_torch.index.layout import LSPIndex


def retrieve_exact(index: LSPIndex, qb: QueryBatch, k: int, doc_chunk: int = 8192):
    """Score every document; exact canonical top-k -> (ids int32 [Q, k], scores [Q, k]).

    Chunked over documents to bound memory. The running merge carries
    (score, doc-id) pairs under the canonical (score desc, id asc) order, which
    composes exactly across chunks, so ties break as in every pruned path."""
    qdense = scatter_dense(qb)
    n_pad = index.doc_remap.shape[0]
    q = qb.tids.shape[0]
    dev = qb.tids.device
    best_s = torch.full((q, k), NEG, dtype=torch.float32, device=dev)
    best_i = torch.full((q, k), index.n_docs, dtype=torch.int32, device=dev)
    for start in range(0, n_pad, doc_chunk):
        pos = torch.arange(start, min(start + doc_chunk, n_pad), device=dev)[None, :].expand(q, -1)
        s = score_positions_fwd(index, qdense, pos)
        ids = index.doc_remap[pos]
        best_s, best_i = canonical_topk(torch.cat([best_s, s], dim=1), torch.cat([best_i, ids], dim=1), k)
    return torch.where(best_s > NEG / 2, best_i, -1), best_s


def score_delta_docs(
    q_tids: np.ndarray,
    q_ws: np.ndarray,
    d_tids: np.ndarray,
    d_ws: np.ndarray,
    vocab: int,
) -> np.ndarray:
    """Exact host-side scores of delta-segment docs against a query batch.

    The delta segment has no superblocks, quantization or pruning: every
    delta doc is scored exactly, in float32, on the host. Queries [Q, nq] and
    docs [D, nd] are padded with the sentinel (tid == ``vocab``, weight 0);
    the sentinel column of the dense scatter is zeroed, so padding adds 0.
    The scatter uses ``np.add.at`` and the reduction a fixed-axis float32
    sum: the JAX package's summation order, bit for bit, which the
    replay-parity property relies on. A query id in [-(vocab+1), -1] wraps
    once, as a numpy index does; any other id outside [0, vocab] adds
    nothing, as in the traversal's ``core.query.scatter_dense`` (the JAX
    package's version raises IndexError there, which stops a serving
    engine's worker). Returns float32 [Q, D].
    """
    q = q_tids.shape[0]
    t = np.asarray(q_tids, np.int64)
    w = np.asarray(q_ws, np.float32)
    t = np.where(t < 0, t + (vocab + 1), t)
    bad = (t < 0) | (t > vocab)  # out of range even after the one wrap
    if bad.any():
        t, w = np.where(bad, vocab, t), np.where(bad, np.float32(0), w)
    qdense = np.zeros((q, vocab + 1), np.float32)
    np.add.at(qdense, (np.arange(q)[:, None], t), w)
    qdense[:, vocab] = 0.0
    if d_tids.size == 0:
        return np.zeros((q, d_tids.shape[0]), np.float32)
    gathered = qdense[:, np.asarray(d_tids, np.int64)]  # [Q, D, nd]
    return (gathered * np.asarray(d_ws, np.float32)[None, :, :]).sum(axis=2, dtype=np.float32)
