"""Plain PyTorch version of the dequant_matmul kernel (same contract, any device)."""

from __future__ import annotations

import torch

from repro_torch.core.bounds import unpack_strided
from repro_torch.index.pack import SEG_WORDS


def dequant_matmul_ref(x: torch.Tensor, packed_w: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 [M, W * 32/bits] = x [M, K] (float32 or bfloat16) @ the
    unpacked int32 words [K, W] (granule 128), accumulated in float32. bfloat16
    values and 4- or 8-bit levels are exact in float32, so the product runs
    there, as the JAX version's float32 accumulation does."""
    w = unpack_strided(packed_w, bits, SEG_WORDS)
    return x.to(torch.float32) @ w.to(torch.float32)
