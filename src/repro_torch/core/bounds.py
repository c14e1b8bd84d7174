"""Helpers of the bound math over packed indexes, shared by the bound wrappers
(``kernels/*/ops.py``) and their plain versions (``kernels/*/ref.py``).

The packed layout is the lane-strided segment format of ``index.pack`` (value
v of segment s lives at word s*G + v%G, bit-lane v//G). β pruning reaches the
bound sums as a mask in the weights: pruned terms are the sentinel
(tid == vocab, weight 0), the clamp keeps the row gather in bounds and the
zero weight kills the contribution.
"""

from __future__ import annotations

import torch

from repro_torch.index.layout import PackedBounds


def unpack_strided(words: torch.Tensor, bits: int, granule_words: int) -> torch.Tensor:
    """int32 words [..., W] (uint32 bits) -> int32 [..., W * vpw] in logical value order."""
    vpw = 32 // bits
    g = granule_words
    lead = words.shape[:-1]
    segs = words.reshape(*lead, words.shape[-1] // g, 1, g)
    shifts = (torch.arange(vpw, dtype=torch.int32, device=words.device) * bits)[:, None]
    vals = (segs >> shifts) & ((1 << bits) - 1)  # [..., s, vpw, g]
    return vals.reshape(*lead, -1)


def fold_scale(pb: PackedBounds, tids: torch.Tensor, ws: torch.Tensor):
    """Fold per-term row scales into the query weights: returns (ws', const_scale),
    which keeps the packed-bound kernels scale-free."""
    if not isinstance(pb.scale, torch.Tensor):
        return ws, pb.scale
    sc = pb.scale[torch.clamp(tids, 0, pb.packed.shape[0] - 1).long()]
    return ws * sc, 1.0


def bound_scores(pb: PackedBounds, tids: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """BoundSum / SBMax (paper Eq. 1): [Q, N] = sum_i ws[:, i] * W[tids[:, i], :].

    Sentinel tids (== vocab) carry ws == 0; clamping the row index keeps the gather
    in-bounds and the zero weight kills the contribution.
    """
    ws, scale = fold_scale(pb, tids, ws)
    rows = pb.packed[torch.clamp(tids, 0, pb.packed.shape[0] - 1).long()]  # [Q, nq, W]
    vals = unpack_strided(rows, pb.bits, pb.granule_words)[..., : pb.n]  # [Q, nq, N]
    return torch.einsum("qi,qin->qn", ws, vals.to(torch.float32)) * scale
