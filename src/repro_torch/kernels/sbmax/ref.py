"""Plain PyTorch version of the sbmax kernel (same contract, any device)."""

from __future__ import annotations

import torch

from repro_torch.core.bounds import unpack_strided


def sbmax_ref(packed: torch.Tensor, tids: torch.Tensor, ws: torch.Tensor, bits: int,
              granule_words: int) -> torch.Tensor:
    """float32 [Q, W * 32/bits] unscaled bound sums; tids pre-clamped."""
    rows = packed[tids.long()]  # [Q, nq, W]
    vals = unpack_strided(rows, bits, granule_words)  # [Q, nq, N_pad]
    return torch.einsum("qi,qin->qn", ws, vals.to(torch.float32))
