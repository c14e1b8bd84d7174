"""Dequant GEMM with the logical-column slice and the scale applied."""

from __future__ import annotations

from typing import Callable

import torch


def dequant_matmul_op(x: torch.Tensor, packed_w: torch.Tensor, bits: int, n: int, scale: float,
                      raw_fn: Callable) -> torch.Tensor:
    """float32 [M, n] = (x @ dequant(packed_w))[:, :n] * scale. ``raw_fn`` is
    ``dequant_matmul_kernel`` or its plain version ``dequant_matmul_ref``
    (``core.ops`` picks one)."""
    raw = raw_fn(x.contiguous(), packed_w, bits)
    return raw[:, :n] * scale
