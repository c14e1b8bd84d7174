"""Plain PyTorch version of the boundsum_gather kernel (same contract, any device)."""

from __future__ import annotations

import torch

from repro_torch.core.bounds import unpack_strided


def boundsum_gather_ref(packed: torch.Tensor, c: int, bits: int, tids: torch.Tensor,
                        ws: torch.Tensor, sel_sb: torch.Tensor, sel_mask: torch.Tensor) -> torch.Tensor:
    """float32 [Q, S, c] unscaled block bound sums; tids and sel_sb
    pre-clamped; 0 where ``sel_mask`` [Q, S] is False."""
    cw = c * bits // 32
    packed3 = packed.view(packed.shape[0], -1, cw)
    sel = packed3[tids.long()[:, :, None], sel_sb.long()[:, None, :]]  # [Q, nq, S, cw]
    vals = unpack_strided(sel, bits, cw)  # [Q, nq, S, c]
    sums = torch.einsum("qi,qisc->qsc", ws, vals.to(torch.float32))
    return torch.where(sel_mask[:, :, None], sums, 0.0)
