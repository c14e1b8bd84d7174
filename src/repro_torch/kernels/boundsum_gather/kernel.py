"""CUDA block-BoundSum gather kernel (``csrc/boundsum_gather.cu``), bound through
ctypes. Replaces ``src/repro/kernels/boundsum_gather/kernel.py::boundsum_gather_pallas``."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def boundsum_gather_kernel(
    packed: torch.Tensor,  # int32 [V, NS * cw] block-level matrix, granule cw
    c: int,
    bits: int,
    tids: torch.Tensor,  # int32 [Q, nq], pre-clamped
    ws: torch.Tensor,  # float32 [Q, nq]
    sel_sb: torch.Tensor,  # int32 [Q, S] selected superblock ids, pre-clamped
    sel_mask: torch.Tensor,  # bool [Q, S]
) -> torch.Tensor:
    """float32 [Q, S, c] unscaled block bound sums of the live (q, s) pairs;
    masked entries are 0 and their granules are not read."""
    dev = packed.device
    _build.check_tensor("packed", packed, torch.int32, 2, dev)
    _build.check_tensor("tids", tids, torch.int32, 2, dev)
    _build.check_tensor("ws", ws, torch.float32, 2, dev)
    _build.check_tensor("sel_sb", sel_sb, torch.int32, 2, dev)
    _build.check_tensor("sel_mask", sel_mask, torch.bool, 2, dev)
    if bits not in (4, 8) or (c * bits) % 32 or c * bits > 32 * 32:
        raise ValueError(f"need bits in (4, 8), c*bits % 32 == 0 and a granule of at most 32 words, "
                         f"got bits={bits}, c={c}")
    cw = c * bits // 32
    q, nq = tids.shape
    s = sel_sb.shape[1]
    if ws.shape != tids.shape or sel_sb.shape[0] != q or packed.shape[1] % cw or sel_mask.shape != sel_sb.shape:
        raise ValueError(f"bad shapes: packed {tuple(packed.shape)}, tids {tuple(tids.shape)}, "
                         f"ws {tuple(ws.shape)}, sel_sb {tuple(sel_sb.shape)}, sel_mask {tuple(sel_mask.shape)}")
    out = torch.empty((q, s, c), dtype=torch.float32, device=dev)
    launch = _build.load("boundsum_gather")
    with torch.cuda.device(dev):
        err = launch(packed.data_ptr(), tids.data_ptr(), ws.data_ptr(), sel_sb.data_ptr(), sel_mask.data_ptr(),
                     out.data_ptr(), q, nq, s, packed.shape[1], cw, bits,
                     torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("boundsum_gather", err)
    boundsum_gather_kernel.launches += 1
    return out


boundsum_gather_kernel.launches = 0
