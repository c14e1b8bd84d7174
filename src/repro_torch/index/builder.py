"""Index construction on the device: CSR corpus (numpy) -> LSPIndex (torch).

Same steps and the same bytes as the JAX package's ``index/builder.py``, which
builds on the host with numpy. Given the same doc order (``doc_remap``) every
leaf is byte-equal; only the k-means that produces that order differs in its
float rounding. At a million documents the dense [V, n_blocks] float32
block-max matrix is ~16 GB, so it is built with one ``scatter_reduce_`` on the
device and quantized and packed there, a chunk of term rows at a time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.index import clustering
from repro_torch.index.layout import FlatDocsQ, FlatInv, FwdDocs, FwdDocsQ, LSPIndex, PackedBounds
from repro_torch.index.pack import SEG_WORDS, align_up, pack_rows_strided
from repro_torch.index.quantize import (
    quantize_bounds,
    quantize_bounds_per_row,
    quantize_weights,
    quantize_weights_per_block,
)

_ROW_CHUNK = 2048  # term rows per quantize-and-pack step of the bound matrices


@dataclass(frozen=True)
class IndexBuildConfig:
    b: int = 8  # docs per block
    c: int = 16  # blocks per superblock
    bound_bits: int = 4  # block/superblock max-weight quantization
    doc_bits: int = 8  # document weight quantization
    # "row" = per-term scales folded into query weights; "global" = one scale
    quant_granularity: str = "row"
    build_flat_inv: bool = True
    build_avg: bool = True  # superblock averages (SP and LSP/2 only)
    lane_pad: int = 8  # alignment of FwdDocsQ.t_pad / FlatDocsQ.m
    d_proj: int = 64
    kmeans_iters: int = 8
    seed: int = 0

    def __post_init__(self):
        assert (self.c * self.bound_bits) % 32 == 0, (
            "superblock gather granule must be word-aligned: c*bound_bits % 32 == 0"
        )


def _numpy_mean_lastaxis(x: torch.Tensor) -> torch.Tensor:
    """float32 mean over the last axis, summed in numpy's pairwise order.

    ``np.mean(axis=-1)`` of a contiguous float32 array adds < 8 values in
    sequence, up to 128 values into 8 strided accumulators combined as
    ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)) plus the tail, and splits longer runs
    in halves. Reproducing that order keeps the superblock averages, and so
    their quantized bytes, equal to the JAX package's host build.
    """

    def pairwise(a):
        n = a.shape[-1]
        if n < 8:
            res = torch.zeros_like(a[..., 0])
            for i in range(n):
                res = res + a[..., i]
            return res
        if n <= 128:
            r = a[..., :8]
            for i in range(8, n - n % 8, 8):
                r = r + a[..., i : i + 8]
            res = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + (
                (r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])
            )
            for i in range(n - n % 8, n):
                res = res + a[..., i]
            return res
        n2 = n // 2
        n2 -= n2 % 8
        return pairwise(a[..., :n2]) + pairwise(a[..., n2:])

    return pairwise(x) / x.shape[-1]


def _bound_matrices(blk_max, cfg, n_superblocks, cw):
    """Quantize and pack the block max, superblock max and superblock avg
    matrices, a chunk of term rows at a time (per-row scales are row-local)."""
    vocab = blk_max.shape[0]
    c, bits = cfg.c, cfg.bound_bits
    per_row = cfg.quant_granularity == "row"

    def sb_reduce(rows):
        return rows.view(rows.shape[0], n_superblocks, c)

    def global_scale(fn):
        # one scale over the whole matrix, from its maximum (as quantize_bounds)
        m = max(float(fn(blk_max[lo : lo + _ROW_CHUNK]).max()) for lo in range(0, vocab, _ROW_CHUNK))
        return quantize_bounds(torch.tensor([m]), bits)[1]

    mats = {"blk": (lambda r: r, cw), "sb": (lambda r: sb_reduce(r).amax(dim=2), SEG_WORDS)}
    if cfg.build_avg:
        mats["avg"] = (lambda r: _numpy_mean_lastaxis(sb_reduce(r)), SEG_WORDS)
    out = {}
    for name, (fn, granule) in mats.items():
        words, scales = [], []
        gscale = None if per_row else global_scale(fn)
        for lo in range(0, vocab, _ROW_CHUNK):
            w = fn(blk_max[lo : lo + _ROW_CHUNK])
            if per_row:
                q, s = quantize_bounds_per_row(w, bits)
                scales.append(s)
            else:
                q, _ = quantize_bounds(w, bits, scale=gscale)
            words.append(pack_rows_strided(q, bits, granule))
        scale = torch.cat(scales) if per_row else gscale
        n = blk_max.shape[1] if name == "blk" else n_superblocks
        out[name] = PackedBounds(torch.cat(words), bits, scale, n, granule)
    return out


def build_index(
    doc_ptr: np.ndarray,
    tids: np.ndarray,
    ws: np.ndarray,
    vocab: int,
    cfg: IndexBuildConfig,
    device: Optional[torch.device] = None,
) -> LSPIndex:
    """Build the two-level index of a CSR corpus on ``device`` (CUDA by default)."""
    device = resolve_device(device)
    n_docs = len(doc_ptr) - 1
    b, c = cfg.b, cfg.c

    remap = clustering.block_order(
        doc_ptr, tids, ws, vocab, b, c, cfg.d_proj, cfg.kmeans_iters, cfg.seed, device=device
    ).to(device, torch.int32)  # position -> original doc id (padded entries == n_docs)
    n_pad = remap.shape[0]
    n_blocks = n_pad // b
    n_superblocks = n_blocks // c

    pos_of = torch.full((n_docs + 1,), -1, dtype=torch.int64, device=device)
    pos_of[remap.long()] = torch.arange(n_pad, device=device)
    lengths = torch.from_numpy(np.diff(doc_ptr)).to(device)
    doc_of_posting = torch.repeat_interleave(torch.arange(n_docs, device=device), lengths)
    post_pos = pos_of[doc_of_posting]
    post_blk = post_pos // b
    t_tids = torch.from_numpy(np.ascontiguousarray(tids, np.int32)).to(device)
    t_ws = torch.from_numpy(np.ascontiguousarray(ws, np.float32)).to(device)

    # ---- dense block-max matrix [V, NB], then sb max / avg and packing per row chunk
    blk_max = torch.zeros((vocab, n_blocks), dtype=torch.float32, device=device)
    blk_max.view(-1).scatter_reduce_(0, t_tids.long() * n_blocks + post_blk, t_ws, "amax")
    cw = c * cfg.bound_bits // 32
    mats = _bound_matrices(blk_max, cfg, n_superblocks, cw)
    del blk_max

    # ---- forward document index (block-ordered, padded term lists)
    t_max = int(lengths.max()) if n_docs else 1
    t_max = max(8, -(-t_max // 8) * 8)
    doc_start = torch.from_numpy(doc_ptr[:-1]).to(device)
    col = torch.arange(len(tids), device=device) - doc_start[doc_of_posting]
    qw, doc_scale = quantize_weights(t_ws, cfg.doc_bits)
    fw_tids = torch.full((n_pad, t_max), vocab, dtype=torch.int32, device=device)
    fw_ws = torch.zeros((n_pad, t_max), dtype=torch.uint8, device=device)
    fw_tids[post_pos, col] = t_tids
    fw_ws[post_pos, col] = qw.to(torch.uint8)
    docs_fwd = FwdDocs(fw_tids, fw_ws, doc_scale, t_max)

    # ---- quantized block-major forward index (doc_score operand, per-block scales)
    qw_blk, blk_scales = quantize_weights_per_block(t_ws, post_blk, n_blocks, cfg.doc_bits)
    t_pad = align_up(t_max, cfg.lane_pad)
    fq_tids = torch.full((n_pad, t_pad), vocab, dtype=torch.int32, device=device)
    fq_ws = torch.zeros((n_pad, t_pad), dtype=torch.int32, device=device)  # no uint16 index_put
    fq_tids[post_pos, col] = t_tids
    fq_ws[post_pos, col] = qw_blk.to(torch.int32)
    docs_fwdq = FwdDocsQ(
        fq_tids.view(n_blocks, b, t_pad), fq_ws.to(qw_blk.dtype).view(n_blocks, b, t_pad), blk_scales,
        cfg.doc_bits, t_pad,
    )

    docs_flat = docs_flatq = None
    if cfg.build_flat_inv:
        docs_flat, docs_flatq = _flat_operands(
            t_tids, qw, qw_blk, post_pos, post_blk, blk_scales, doc_scale, vocab, b, n_blocks, cfg
        )

    return LSPIndex(
        b=b,
        c=c,
        n_docs=n_docs,
        vocab=vocab,
        n_blocks=n_blocks,
        n_superblocks=n_superblocks,
        sb_bounds=mats["sb"],
        blk_bounds=mats["blk"],
        sb_avg=mats.get("avg"),
        docs_fwd=docs_fwd,
        docs_flat=docs_flat,
        doc_remap=remap,
        docs_fwdq=docs_fwdq,
        docs_flatq=docs_flatq,
    )


def _flat_operands(t_tids, qw, qw_blk, post_pos, post_blk, blk_scales, doc_scale, vocab, b, n_blocks, cfg):
    """Flat compact inverted index (postings sorted by (block, local doc, term))
    and its quantized block-major segments."""
    device = t_tids.device
    # lexsort((tids, did, blk)) == stable sort on (position, term id)
    order = torch.argsort(post_pos * (vocab + 1) + t_tids.long(), stable=True)
    s_tid = t_tids[order]
    s_did = (post_pos[order] % b).to(torch.int32)
    counts = torch.bincount(post_blk, minlength=n_blocks)
    block_ptr = torch.zeros(n_blocks + 1, dtype=torch.int64, device=device)
    block_ptr[1:] = torch.cumsum(counts, dim=0)
    max_nnz = int(counts.max()) if n_blocks else 0
    max_nnz = max(8, -(-max_nnz // 8) * 8)
    pad = max_nnz  # sentinel postings so gathers of max_nnz past the end are safe
    docs_flat = FlatInv(
        torch.cat([s_tid, torch.full((pad,), vocab, dtype=torch.int32, device=device)]),
        torch.cat([s_did, torch.zeros(pad, dtype=torch.int32, device=device)]),
        # int32 on the way: CUDA has no uint16 gather or cat (doc_bits=16)
        torch.cat([qw.to(torch.int32)[order], torch.zeros(pad, dtype=torch.int32, device=device)]).to(qw.dtype),
        block_ptr.to(torch.int32),
        max_nnz,
        doc_scale,
    )

    m = align_up(max_nnz, cfg.lane_pad)
    row = post_blk[order]
    off = torch.arange(len(order), device=device) - block_ptr[row]
    fl_tids = torch.full((n_blocks, m), vocab, dtype=torch.int32, device=device)
    fl_ws = torch.zeros((n_blocks, m), dtype=torch.int32, device=device)
    fl_tids[row, off] = s_tid
    fl_ws[row, off] = qw_blk.to(torch.int32)[order]
    did_counts = torch.bincount(row * b + s_did, minlength=n_blocks * b).view(n_blocks, b)
    doc_ends = torch.cumsum(did_counts, dim=1).to(torch.int32)
    docs_flatq = FlatDocsQ(fl_tids, fl_ws.to(qw_blk.dtype), doc_ends, blk_scales, cfg.doc_bits, m)
    return docs_flat, docs_flatq
