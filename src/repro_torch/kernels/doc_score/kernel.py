"""CUDA fused document-scoring kernel, forward layout (``csrc/doc_score.cu``),
bound through ctypes. Replaces ``src/repro/kernels/doc_score/kernel.py::doc_score_fwd_pallas``."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_SMEM_BYTES = 232_448  # dynamic shared memory one H100 thread block may use
BLOCKS_PER_CTA = 128  # selected blocks scored by one thread block (one qdense row copy)


def doc_score_fwd_kernel(
    tids3: torch.Tensor,  # int32 [NB, b, T]
    ws3: torch.Tensor,  # uint8 / uint16 [NB, b, T]
    qdense: torch.Tensor,  # float32 [Q, Vp], sentinel column zero
    blk_ids: torch.Tensor,  # int32 [Q, S], pre-clamped to [0, NB)
) -> torch.Tensor:
    """float32 [Q, S, b] raw (unscaled) per-document scores."""
    dev = tids3.device
    _build.check_tensor("tids3", tids3, torch.int32, 3, dev)
    _build.check_tensor("ws3", ws3, ws3.dtype, 3, dev)
    _build.check_tensor("qdense", qdense, torch.float32, 2, dev)
    _build.check_tensor("blk_ids", blk_ids, torch.int32, 2, dev)
    if ws3.dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"ws3 must be uint8 or uint16, got {ws3.dtype}")
    _, b, t = tids3.shape
    q, s = blk_ids.shape
    vp = qdense.shape[1]
    if ws3.shape != tids3.shape or qdense.shape[0] != q or q > 65535:
        raise ValueError(f"bad shapes: tids3 {tuple(tids3.shape)}, ws3 {tuple(ws3.shape)}, "
                         f"qdense {tuple(qdense.shape)}, blk_ids {tuple(blk_ids.shape)}")
    if vp * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"the dense query row ({vp} floats) must fit in {MAX_SMEM_BYTES} bytes of shared memory")
    out = torch.empty((q, s, b), dtype=torch.float32, device=dev)
    launch = _build.load("doc_score")
    with torch.cuda.device(dev):
        err = launch(tids3.data_ptr(), ws3.data_ptr(), qdense.data_ptr(), blk_ids.data_ptr(),
                     out.data_ptr(), q, s, b, t, vp, ws3.element_size(), BLOCKS_PER_CTA,
                     torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("doc_score_fwd", err)
    doc_score_fwd_kernel.launches += 1
    return out


doc_score_fwd_kernel.launches = 0
