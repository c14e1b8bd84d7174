"""Index operands: NamedTuples of torch tensors, one per JAX ``index/layout.py`` type.

Packed ``uint32`` words are held as ``int32`` views of the same bits: for
``s + bits <= 32``, ``(w >> s) & mask`` on the int32 view gives the same low
bits as on the unsigned word, and torch has no ``>>`` for ``uint32`` on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

# Version of the on-disk layout (``index.store``): equal to the JAX package's,
# whose directories this port reads and writes. A change to any type below
# that alters a saved leaf bumps it.
LAYOUT_VERSION = 1


class PackedBounds(NamedTuple):
    """Term-major packed block/superblock max (or avg) term weights.

    packed: int32 [V, n_words] (uint32 bits) in the lane-strided layout of
    ``index.pack``; the block-level matrix keeps superblock s's blocks in the
    contiguous granule [s*c, (s+1)*c).
    """

    packed: torch.Tensor
    bits: int
    scale: Union[float, torch.Tensor]  # float (global) or float32 [V] (per-term rows)
    n: int  # logical number of units (n_blocks or n_superblocks)
    granule_words: int  # lane-strided packing granule

    @property
    def vocab(self) -> int:
        return self.packed.shape[0]


class FwdDocs(NamedTuple):
    """Forward index: per-document padded (term-id, weight) lists, block-ordered."""

    tids: torch.Tensor  # int32 [n_docs_padded, t_max], padded with vocab
    ws: torch.Tensor  # uint8 [n_docs_padded, t_max]
    scale: float
    t_max: int


class FlatInv(NamedTuple):
    """Flat compact inverted index: postings sorted by (block, local doc, term)."""

    tids: torch.Tensor  # int32 [nnz_padded]
    local_dids: torch.Tensor  # int32 [nnz_padded]
    ws: torch.Tensor  # uint8 [nnz_padded]
    block_ptr: torch.Tensor  # int32 [n_blocks + 1]
    max_block_nnz: int
    scale: float


class FwdDocsQ(NamedTuple):
    """Quantized block-major forward index: the doc_score kernel operand."""

    tids: torch.Tensor  # int32 [n_blocks, b, t_pad], padded with vocab
    ws: torch.Tensor  # uint8/uint16 [n_blocks, b, t_pad]
    scales: torch.Tensor  # float32 [n_blocks] per-block dequant scale
    bits: int
    t_pad: int


class FlatDocsQ(NamedTuple):
    """Quantized block-major flat postings (the flat-layout scoring operand)."""

    tids: torch.Tensor  # int32 [n_blocks, m]
    ws: torch.Tensor  # uint8/uint16 [n_blocks, m]
    doc_ends: torch.Tensor  # int32 [n_blocks, b]
    scales: torch.Tensor  # float32 [n_blocks]
    bits: int
    m: int


class LSPIndex(NamedTuple):
    """The built two-level index; every tensor lives on one device."""

    b: int  # docs per block
    c: int  # blocks per superblock
    n_docs: int
    vocab: int
    n_blocks: int
    n_superblocks: int
    sb_bounds: PackedBounds
    blk_bounds: PackedBounds
    sb_avg: Optional[PackedBounds]
    docs_fwd: FwdDocs
    docs_flat: Optional[FlatInv]
    doc_remap: torch.Tensor  # int32 [n_docs_padded]: position -> original doc id
    docs_fwdq: Optional[FwdDocsQ] = None
    docs_flatq: Optional[FlatDocsQ] = None


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):
        for v in x:
            yield from _tensors(v)


def index_device(index: LSPIndex) -> torch.device:
    return index.doc_remap.device


def index_nbytes(index: LSPIndex) -> int:
    """Bytes the index holds in tensors (on its device)."""
    return sum(t.numel() * t.element_size() for t in _tensors(index))


def index_to(index: LSPIndex, device) -> LSPIndex:
    """A copy of ``index`` with every tensor on ``device`` (itself if already there)."""
    device = torch.device(device)
    if index_device(index) == device:
        return index

    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(move(v) for v in x))
        return x

    return move(index)


# ----------------------------------------------------------------- size accounting
# Byte formulas mirroring paper §4.3 / Table 7. `nnz` is total postings count.


def bmp_inv_bytes(nnz: int, n_blocks: int, vocab_per_block) -> int:
    """Rust nested Vec<Vec<(u32,u8)>>: 24B header per vector + postings (5B each)."""
    n_vecs = int(vocab_per_block.sum()) + n_blocks  # per (block,term) vec + outer vecs
    return 24 * n_vecs + 5 * nnz


def compact_inv_bytes(nnz: int, n_blocks: int, vocab_per_block) -> int:
    """b<=256 -> 1B lengths; 65k terms -> 2B term ids; no per-vec capacity/ptr."""
    n_lists = int(vocab_per_block.sum())
    return n_lists * (2 + 1) + 2 * nnz + 8 * n_blocks  # tid+len per list, (did,w) 2B


def flat_inv_bytes(nnz_padded: int, n_blocks: int) -> int:
    # int32 tid (we budget 2B logical term ids at 65k vocab) + 1B local did + 1B w
    return 4 * nnz_padded + 4 * (n_blocks + 1)


def fwd_bytes(n_docs_padded: int, t_max: int) -> int:
    return n_docs_padded * t_max * (4 + 1)  # int32 tid + u8 weight


def fwdq_bytes(fq: FwdDocsQ) -> int:
    n_blocks, b, t = fq.tids.shape
    return n_blocks * (b * t * (4 + fq.ws.dtype.itemsize) + 4)  # + per-block scale


def flatq_bytes(fq: FlatDocsQ) -> int:
    n_blocks, m = fq.tids.shape
    b = fq.doc_ends.shape[1]
    return n_blocks * (m * (4 + fq.ws.dtype.itemsize) + 4 * b + 4)


def dense_bounds_bytes(vocab: int, n_units: int, bits: int = 8) -> int:
    """BMP-Dense: uncompressed dense max-weight matrix."""
    return vocab * n_units * bits // 8


def sparse_bounds_bytes(nnz_block_terms: int) -> int:
    """BMP-Sparse: (block_id u32, weight u8) per nonzero block-term."""
    return 5 * nnz_block_terms


def packed_bounds_bytes(pb: PackedBounds) -> int:
    return pb.packed.numel() * 4
