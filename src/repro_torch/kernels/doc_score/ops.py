"""Quantized forward operand -> scaled per-document scores of selected blocks."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.index.layout import FwdDocsQ


def doc_score_fwd_op(fwdq: FwdDocsQ, qdense: torch.Tensor, blk_ids: torch.Tensor,
                     raw_fn: Callable) -> torch.Tensor:
    """[Q, S] selected blocks -> scores float32 [Q, S, b] with the per-block
    dequant scales applied. Clamps block ids and runs ``raw_fn``:
    ``doc_score_fwd_kernel`` or its plain version ``doc_score_fwd_ref``
    (``core.ops`` picks one). The caller masks padded or ineligible blocks."""
    blk_c = torch.clamp(blk_ids, 0, fwdq.tids.shape[0] - 1).to(torch.int32).contiguous()
    raw = raw_fn(fwdq.tids, fwdq.ws, qdense.to(torch.float32).contiguous(), blk_c)
    return raw * fwdq.scales[blk_c.long()][:, :, None]
