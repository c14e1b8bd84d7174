"""Plain PyTorch version of the doc_score_fwd kernel (same contract, any device)."""

from __future__ import annotations

import torch


def gather_weights(ws: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """float32 ``ws[idx]`` of quantized weights. CUDA has no uint16 gather, so
    16-bit weights go through an int16 view and are masked back to unsigned."""
    if ws.dtype == torch.uint16:
        return (ws.view(torch.int16)[idx].to(torch.int32) & 0xFFFF).to(torch.float32)
    return ws[idx].to(torch.float32)


def doc_score_fwd_ref(tids3: torch.Tensor, ws3: torch.Tensor, qdense: torch.Tensor,
                      blk_ids: torch.Tensor) -> torch.Tensor:
    """float32 [Q, S, b] raw per-document scores of blocks ``blk_ids`` [Q, S]
    (pre-clamped). Sentinel term ids (== vocab) hit the zero column of qdense."""
    q = blk_ids.shape[0]
    t = tids3[blk_ids.long()]  # [Q, S, b, T]
    w = gather_weights(ws3, blk_ids.long())
    qv = torch.gather(qdense, 1, t.reshape(q, -1).long()).view(t.shape)
    return (qv * w).sum(dim=-1)
