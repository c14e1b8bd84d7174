"""CUDA fused document-scoring kernels, bound through ctypes: the forward
layout (``csrc/doc_score.cu``, replaces
``src/repro/kernels/doc_score/kernel.py::doc_score_fwd_pallas``) and the flat
layout (``csrc/doc_score_flat.cu``, replaces ``doc_score_flat_pallas``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _check_common(ws: torch.Tensor, qdense: torch.Tensor, blk_ids: torch.Tensor, dev) -> None:
    _build.check_tensor("qdense", qdense, torch.float32, 2, dev)
    _build.check_tensor("blk_ids", blk_ids, torch.int32, 2, dev)
    if ws.dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"ws must be uint8 or uint16, got {ws.dtype}")
    if qdense.shape[0] != blk_ids.shape[0]:
        raise ValueError(f"bad shapes: qdense {tuple(qdense.shape)}, blk_ids {tuple(blk_ids.shape)}")


def doc_score_fwd_kernel(
    tids3: torch.Tensor,  # int32 [NB, b, T]
    ws3: torch.Tensor,  # uint8 / uint16 [NB, b, T]
    qdense: torch.Tensor,  # float32 [Q, Vp], sentinel column zero
    blk_ids: torch.Tensor,  # int32 [Q, S], pre-clamped to [0, NB)
    blk_mask: torch.Tensor,  # bool [Q, S]
) -> torch.Tensor:
    """float32 [Q, S, b] raw (unscaled) per-document scores of the live
    blocks; masked (q, s) entries are 0 and their blocks are not read. A run
    of 8 or more live blocks of one query copies its dense query row into
    shared memory where the row fits; shorter runs, and rows too long for
    shared memory, look their terms up through L2."""
    dev = tids3.device
    _build.check_tensor("tids3", tids3, torch.int32, 3, dev)
    _build.check_tensor("ws3", ws3, ws3.dtype, 3, dev)
    _build.check_tensor("blk_mask", blk_mask, torch.bool, 2, dev)
    _check_common(ws3, qdense, blk_ids, dev)
    if ws3.shape != tids3.shape or blk_mask.shape != blk_ids.shape:
        raise ValueError(f"bad shapes: tids3 {tuple(tids3.shape)}, ws3 {tuple(ws3.shape)}, "
                         f"blk_ids {tuple(blk_ids.shape)}, blk_mask {tuple(blk_mask.shape)}")
    _, b, t = tids3.shape
    q, s = blk_ids.shape
    if q * s >= 2**31:
        raise ValueError(f"too many (query, block) pairs: {q} x {s}")
    out = torch.empty((q, s, b), dtype=torch.float32, device=dev)
    launch = _build.load("doc_score")
    with torch.cuda.device(dev):
        err = launch(tids3.data_ptr(), ws3.data_ptr(), qdense.data_ptr(), blk_ids.data_ptr(), blk_mask.data_ptr(),
                     out.data_ptr(), q, s, b, t, qdense.shape[1], ws3.element_size(),
                     torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("doc_score_fwd", err)
    doc_score_fwd_kernel.launches += 1
    return out


doc_score_fwd_kernel.launches = 0


def doc_score_flat_kernel(
    tids: torch.Tensor,  # int32 [NB, m], postings sorted by local doc
    ws: torch.Tensor,  # uint8 / uint16 [NB, m]
    doc_ends: torch.Tensor,  # int32 [NB, b], end of each document's run
    qdense: torch.Tensor,  # float32 [Q, Vp], sentinel column zero
    blk_ids: torch.Tensor,  # int32 [Q, S], pre-clamped to [0, NB)
    blk_mask: torch.Tensor,  # bool [Q, S]
) -> torch.Tensor:
    """float32 [Q, S, b] raw (unscaled) per-document scores of the live
    blocks; masked (q, s) entries are 0 and their blocks are not read. Each
    live block's first ``doc_ends[blk, b-1]`` postings are read, not its
    padding; the dense query row goes where ``doc_score_fwd_kernel`` puts it."""
    dev = tids.device
    _build.check_tensor("tids", tids, torch.int32, 2, dev)
    _build.check_tensor("ws", ws, ws.dtype, 2, dev)
    _build.check_tensor("doc_ends", doc_ends, torch.int32, 2, dev)
    _build.check_tensor("blk_mask", blk_mask, torch.bool, 2, dev)
    _check_common(ws, qdense, blk_ids, dev)
    if ws.shape != tids.shape or doc_ends.shape[0] != tids.shape[0] or blk_mask.shape != blk_ids.shape:
        raise ValueError(f"bad shapes: tids {tuple(tids.shape)}, ws {tuple(ws.shape)}, "
                         f"doc_ends {tuple(doc_ends.shape)}, blk_ids {tuple(blk_ids.shape)}, "
                         f"blk_mask {tuple(blk_mask.shape)}")
    nb, m = tids.shape
    b = doc_ends.shape[1]
    q, s = blk_ids.shape
    if q * s >= 2**31:
        raise ValueError(f"too many (query, block) pairs: {q} x {s}")
    out = torch.empty((q, s, b), dtype=torch.float32, device=dev)
    launch = _build.load("doc_score_flat")
    with torch.cuda.device(dev):
        err = launch(tids.data_ptr(), ws.data_ptr(), doc_ends.data_ptr(), qdense.data_ptr(), blk_ids.data_ptr(),
                     blk_mask.data_ptr(), out.data_ptr(), q, s, nb, b, m, qdense.shape[1], ws.element_size(),
                     torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("doc_score_flat", err)
    doc_score_flat_kernel.launches += 1
    return out


doc_score_flat_kernel.launches = 0
