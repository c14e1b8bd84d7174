"""Quantized document operands -> scaled per-document scores of selected blocks."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.index.layout import FlatDocsQ, FwdDocsQ


def _clamp(blk_ids: torch.Tensor, n_blocks: int) -> torch.Tensor:
    return torch.clamp(blk_ids, 0, n_blocks - 1).to(torch.int32).contiguous()


def doc_score_fwd_op(fwdq: FwdDocsQ, qdense: torch.Tensor, blk_ids: torch.Tensor, blk_mask: torch.Tensor,
                     raw_fn: Callable) -> torch.Tensor:
    """[Q, S] selected blocks and their mask -> scores float32 [Q, S, b] with
    the per-block dequant scales applied, 0 for masked blocks. Clamps block
    ids and runs ``raw_fn``: ``doc_score_fwd_kernel``, which reads only the
    live blocks, or its plain version ``doc_score_fwd_ref`` (``core.ops``
    picks one)."""
    blk_c = _clamp(blk_ids, fwdq.tids.shape[0])
    raw = raw_fn(fwdq.tids, fwdq.ws, qdense.to(torch.float32).contiguous(), blk_c, blk_mask.contiguous())
    return raw * fwdq.scales[blk_c.long()][:, :, None]


def doc_score_flat_op(flatq: FlatDocsQ, qdense: torch.Tensor, blk_ids: torch.Tensor, blk_mask: torch.Tensor,
                      raw_fn: Callable) -> torch.Tensor:
    """``doc_score_fwd_op`` over the flat operand: ``raw_fn`` is
    ``doc_score_flat_kernel``, which reads only the live blocks, or its plain
    version ``doc_score_flat_ref``; both give 0 for masked blocks."""
    blk_c = _clamp(blk_ids, flatq.tids.shape[0])
    raw = raw_fn(flatq.tids, flatq.ws, flatq.doc_ends, qdense.to(torch.float32).contiguous(), blk_c,
                 blk_mask.contiguous())
    return raw * flatq.scales[blk_c.long()][:, :, None]
