"""CUDA SBMax / BoundSum kernel (``csrc/sbmax.cu``), bound through ctypes.

Replaces ``src/repro/kernels/sbmax/kernel.py::sbmax_pallas``. Unlike the TPU
kernel, which unpacks 128-word tiles only, it takes the packing granule as an
argument, so it also serves bmp's BoundSum over the block matrix (granule
c*bits/32). Any number of queries and of term slots a query.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def sbmax_kernel(
    packed: torch.Tensor,  # int32 [V, W] (uint32 words), W % granule_words == 0
    tids: torch.Tensor,  # int32 [Q, nq], pre-clamped to [0, V)
    ws: torch.Tensor,  # float32 [Q, nq], 0 for padded / pruned terms
    bits: int,
    granule_words: int,
) -> torch.Tensor:
    """float32 [Q, W * 32/bits] unscaled bound sums in logical value order.
    Refuses what the kernel does not take before anything is launched: bad
    bits or shapes first, then tensors that are not contiguous CUDA tensors
    of the right type."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if (packed.ndim != 2 or tids.ndim != 2 or ws.shape != tids.shape or granule_words < 1
            or packed.shape[1] % granule_words):
        raise ValueError(f"bad shapes: packed {tuple(packed.shape)}, tids {tuple(tids.shape)}, "
                         f"ws {tuple(ws.shape)}, granule {granule_words}")
    dev = packed.device
    _build.check_tensor("packed", packed, torch.int32, 2, dev)
    _build.check_tensor("tids", tids, torch.int32, 2, dev)
    _build.check_tensor("ws", ws, torch.float32, 2, dev)
    q, nq = tids.shape
    n_words = packed.shape[1]
    out = torch.empty((q, n_words * (32 // bits)), dtype=torch.float32, device=dev)
    launch = _build.load("sbmax")
    with torch.cuda.device(dev):
        err = launch(packed.data_ptr(), tids.data_ptr(), ws.data_ptr(), out.data_ptr(),
                     q, nq, n_words, granule_words, bits, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("sbmax", err)
    sbmax_kernel.launches += 1
    return out


sbmax_kernel.launches = 0
