"""The yardstick of the kernels: the peaks of the card and the work of one
call, counted from the call's inputs.

A call's least time is the larger of its bytes over the HBM rate and its
float32 operations over the card's float32 rate (NVIDIA's H100 SXM data
sheet, at its 700 W limit). The work functions count what these inputs
need, not the most they could: masked kernels count their live pairs only,
each distinct row, granule or block read once, the output written once.
They are copies of ``chip_smoke.py``'s ``sbmax_work``, ``boundsum_work`` and
``doc_score_work``, except that ``doc_score_fwd`` takes the width of the
dense query rows instead of the rows themselves (only their width enters the
count, and the benchmark does not keep the rows).
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def sbmax_work(packed, tids, ws, bits, granule):
    """(bytes, float32 operations) of one ``sbmax_kernel`` call: the bound
    rows of the distinct live terms, the query terms, the output written
    once; two operations per live term and bound."""
    live = ws != 0
    rows = torch.unique(tids[live]).numel()
    w = packed.shape[1]
    vpw = 32 // bits
    nbytes = rows * w * 4 + _nbytes(tids, ws) + tids.shape[0] * w * vpw * 4
    return nbytes, 2.0 * int(live.sum()) * w * vpw


def boundsum_work(packed, c, bits, tids, ws, sel, mask):
    """One ``boundsum_gather_kernel`` call: the granules of the live (term,
    eligible superblock) pairs (each distinct one read once), the query
    terms, the mask, the eligible pairs' superblock ids, the output written
    once; two operations per live term and bound."""
    cw = c * bits // 32
    live = (ws != 0)[:, :, None] & mask[:, None, :]  # [Q, nq, S]
    pairs = tids.long()[:, :, None] * (packed.shape[1] // cw) + sel.long()[:, None, :]
    granules = torch.unique(pairs[live]).numel()
    nbytes = granules * cw * 4 + _nbytes(tids, ws, mask) + int(mask.sum()) * 4 + sel.numel() * c * 4
    return nbytes, 2.0 * int(live.sum()) * c


def doc_score_work(tids3, ws3, vp, blk, mask):
    """One ``doc_score_fwd_kernel`` call (``vp``: the width of the dense query
    rows): the live blocks (each distinct one read once), the 32-byte sectors
    of the dense query rows that their non-sentinel slots look up (each
    distinct one read once), the mask, the live pairs' block ids, the output
    written once; an FMA on each live non-sentinel slot."""
    _, b, t = tids3.shape
    live = blk[mask].long()
    blocks = torch.unique(live).numel()
    looked_up = tids3[live].reshape(live.numel(), b * t).long()  # [live pairs, b*T]
    slot = looked_up != vp - 1  # non-sentinel slots
    q_of = mask.nonzero()[:, 0][:, None].expand_as(looked_up)
    sectors = torch.unique((q_of * vp + looked_up)[slot] // 8).numel()  # 8 floats a sector
    nbytes = (blocks * b * t * (4 + ws3.element_size()) + sectors * 32 + _nbytes(mask)
              + live.numel() * 4 + blk.numel() * b * 4)
    return nbytes, 2.0 * int(slot.sum())


# name -> (core.ops attribute that launches it, part of its device name,
# the work of one call from the launch's arguments, which argument holds the
# dense query rows (kept as their width) or None)
KERNELS = {
    "sbmax": ("sbmax_kernel", "sbmax_kernel", sbmax_work, None),
    "boundsum_gather": ("boundsum_gather_kernel", "boundsum_gather_kernel", boundsum_work, None),
    "doc_score_fwd": ("doc_score_fwd_kernel", "doc_score_fwd_kernel", doc_score_work, 2),
}
