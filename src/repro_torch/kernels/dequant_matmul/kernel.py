"""CUDA dequant GEMM (``csrc/dequant_matmul.cu``), bound through ctypes.

Replaces ``src/repro/kernels/dequant_matmul/kernel.py::dequant_matmul_pallas``.
Unlike the TPU kernel, whose wrapper asserts M % 128 == 0, it takes any M.
"""

from __future__ import annotations

import torch

from repro_torch.index.pack import SEG_WORDS
from repro_torch.kernels import _build

MAX_WORD_TILES = 65535  # grid.y: W / 32 thread blocks of 32 packed words (grid.x, the row tiles, has no limit)


def dequant_matmul_kernel(
    x: torch.Tensor,  # float32 / bfloat16 [M, K]
    packed_w: torch.Tensor,  # int32 [K, W] (uint32 words), granule 128, W % 128 == 0
    bits: int,
) -> torch.Tensor:
    """float32 [M, W * 32/bits] unscaled products in logical column order."""
    dev = packed_w.device
    _build.check_tensor("x", x, x.dtype, 2, dev)
    _build.check_tensor("packed_w", packed_w, torch.int32, 2, dev)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    m, k = x.shape
    n_words = packed_w.shape[1]
    if packed_w.shape[0] != k or n_words % SEG_WORDS or n_words // 32 > MAX_WORD_TILES:
        raise ValueError(f"bad shapes: x {tuple(x.shape)}, packed_w {tuple(packed_w.shape)}")
    if packed_w.data_ptr() % 16:
        raise ValueError("packed_w must be 16-byte aligned: the kernel stages it with 16-byte cp.async copies")
    out = torch.empty((m, n_words * (32 // bits)), dtype=torch.float32, device=dev)
    launch = _build.load("dequant_matmul")
    with torch.cuda.device(dev):
        err = launch(x.data_ptr(), packed_w.data_ptr(), out.data_ptr(), m, k, n_words, bits,
                     x.element_size(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("dequant_matmul", err)
    dequant_matmul_kernel.launches += 1
    return out


dequant_matmul_kernel.launches = 0
