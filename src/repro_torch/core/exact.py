"""Rank-safe exhaustive scoring: the recall oracle."""

from __future__ import annotations

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
