"""Block-level PackedBounds -> scaled block BoundSums of the selected superblocks."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.bounds import fold_scale
from repro_torch.index.layout import PackedBounds


def boundsum_gather_op(pb: PackedBounds, c: int, tids: torch.Tensor, ws: torch.Tensor,
                       sel_sb: torch.Tensor, sel_mask: torch.Tensor, raw_fn: Callable) -> torch.Tensor:
    """[Q, S, c] block bounds of superblocks ``sel_sb`` [Q, S], 0 where
    ``sel_mask`` [Q, S] is False. Folds the scales, clamps term and superblock
    ids and runs ``raw_fn``: ``boundsum_gather_kernel``, which reads no masked
    granule, or its plain version ``boundsum_gather_ref`` (``core.ops`` picks
    one)."""
    assert pb.granule_words == c * pb.bits // 32, "block matrix must be packed at superblock granule"
    ws, scale = fold_scale(pb, tids, ws)
    v = pb.packed.shape[0]
    tids = torch.clamp(tids, 0, v - 1).to(torch.int32).contiguous()
    sel_sb = torch.clamp(sel_sb, 0, pb.packed.shape[1] // pb.granule_words - 1).to(torch.int32).contiguous()
    return raw_fn(pb.packed, c, pb.bits, tids, ws.to(torch.float32).contiguous(), sel_sb,
                  sel_mask.contiguous()) * scale
