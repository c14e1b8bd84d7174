"""Plain PyTorch versions of the doc_score kernels (same contracts, any device)."""

from __future__ import annotations

import torch


def gather_weights(ws: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """float32 ``ws[idx]`` of quantized weights. CUDA has no uint16 gather, so
    16-bit weights go through an int16 view and are masked back to unsigned."""
    if ws.dtype == torch.uint16:
        return (ws.view(torch.int16)[idx].to(torch.int32) & 0xFFFF).to(torch.float32)
    return ws[idx].to(torch.float32)


def doc_score_fwd_ref(tids3: torch.Tensor, ws3: torch.Tensor, qdense: torch.Tensor,
                      blk_ids: torch.Tensor, blk_mask: torch.Tensor) -> torch.Tensor:
    """float32 [Q, S, b] raw per-document scores of blocks ``blk_ids`` [Q, S]
    (pre-clamped), 0 where ``blk_mask`` [Q, S] is False. Sentinel term ids
    (== vocab) hit the zero column of qdense."""
    q = blk_ids.shape[0]
    t = tids3[blk_ids.long()]  # [Q, S, b, T]
    w = gather_weights(ws3, blk_ids.long())
    qv = torch.gather(qdense, 1, t.reshape(q, -1).long()).view(t.shape)
    return torch.where(blk_mask[:, :, None], (qv * w).sum(dim=-1), 0.0)


def doc_score_flat_ref(tids: torch.Tensor, ws: torch.Tensor, doc_ends: torch.Tensor, qdense: torch.Tensor,
                       blk_ids: torch.Tensor, blk_mask: torch.Tensor) -> torch.Tensor:
    """float32 [Q, S, b] raw per-document scores over flat postings: tids and
    ws [NB, m] sorted by local doc, ``doc_ends`` [NB, b] the end of each
    document's run, ``blk_ids`` [Q, S] pre-clamped; 0 where ``blk_mask``
    [Q, S] is False.

    Each document's score is the difference of a prefix sum over its block's
    segment at the run's two ends. The prefix sums are float64: in float32
    their rounding error grows with the block's total rather than the
    document's score, which on blocks that phase 3 selects (totals ~1e4)
    exceeds rtol=1e-5, atol=1e-4 against a direct sum of the run."""
    q, s = blk_ids.shape
    blk = blk_ids.long()
    t = tids[blk]  # [Q, S, m]
    qv = torch.gather(qdense, 1, t.reshape(q, -1).long()).view(t.shape)
    contrib = qv.to(torch.float64) * gather_weights(ws, blk).to(torch.float64)
    cs = torch.nn.functional.pad(torch.cumsum(contrib, dim=-1), (1, 0))  # [Q, S, m+1]
    ends = doc_ends[blk].long()  # [Q, S, b]
    starts = torch.nn.functional.pad(ends[..., :-1], (1, 0))
    raw = (cs.gather(-1, ends) - cs.gather(-1, starts)).to(torch.float32)
    return torch.where(blk_mask[:, :, None], raw, 0.0)
