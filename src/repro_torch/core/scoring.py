"""Document scoring over candidate blocks (fwd and flat layouts) or positions.

Scoring uses the FULL query, dense-scattered; the pruned query only picks
candidates. Every block score goes through ``score_blocks`` ->
``ops.score_gather``; ``score_positions_fwd`` serves the exact oracle and
reads the same per-block-quantized weights, so every path scores with the
same arithmetic.
"""

from __future__ import annotations

import torch

from repro_torch.core import ops
from repro_torch.index.layout import LSPIndex
from repro_torch.kernels.doc_score.ref import gather_weights

NEG = -1e30


def score_positions_fwd(index: LSPIndex, qdense: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Score docs at block-ordered positions. qdense [Q, V+1]; pos [Q, D] -> [Q, D].
    Padded positions (remap sentinel) score NEG."""
    fwdq = index.docs_fwdq
    b = index.b
    pos_c = torch.clamp(pos, 0, index.doc_remap.shape[0] - 1)
    blk, did = pos_c // b, pos_c % b
    tids = fwdq.tids[blk, did]  # [Q, D, T]
    ws = gather_weights(fwdq.ws, blk, did)
    qv = torch.gather(qdense, 1, tids.reshape(tids.shape[0], -1).long()).view(tids.shape)
    scores = (qv * ws).sum(dim=-1) * fwdq.scales[blk]
    valid = index.doc_remap[pos_c] < index.n_docs
    return torch.where(valid, scores, NEG)


def score_blocks(
    index: LSPIndex,
    qdense: torch.Tensor,
    blk_ids: torch.Tensor,
    blk_mask: torch.Tensor,
    layout: str = "fwd",
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score all docs of the selected blocks from the ``layout`` operand:
    blk_ids/blk_mask [Q, S] -> (scores [Q, S*b], positions [Q, S*b]). Masked
    blocks and padded docs score NEG."""
    b = index.b
    scores = ops.score_gather(index, qdense, blk_ids, blk_mask, layout, impl)  # [Q, S, b]
    pos = blk_ids[:, :, None] * b + torch.arange(b, device=blk_ids.device)[None, None, :]
    valid = index.doc_remap[torch.clamp(pos, 0, index.doc_remap.shape[0] - 1)] < index.n_docs
    scores = torch.where(valid & blk_mask[:, :, None], scores, NEG)
    return scores.reshape(scores.shape[0], -1), pos.reshape(pos.shape[0], -1)
