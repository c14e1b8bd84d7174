"""PackedBounds -> scaled SBMax / BoundSum scores through the sbmax kernel."""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.bounds import fold_scale
from repro_torch.index.layout import PackedBounds


def sbmax_op(pb: PackedBounds, tids: torch.Tensor, ws: torch.Tensor, raw_fn: Callable) -> torch.Tensor:
    """[Q, pb.n] bound sums. Folds the per-term scales into the weights, clamps
    the term ids and runs ``raw_fn``: ``sbmax_kernel`` or its plain version
    ``sbmax_ref`` (``core.ops`` picks one)."""
    ws, scale = fold_scale(pb, tids, ws)
    tids = torch.clamp(tids, 0, pb.packed.shape[0] - 1).to(torch.int32).contiguous()
    raw = raw_fn(pb.packed, tids, ws.to(torch.float32).contiguous(), pb.bits, pb.granule_words)
    return raw[:, : pb.n] * scale
