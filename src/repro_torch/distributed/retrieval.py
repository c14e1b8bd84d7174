"""Contiguous superblock-range shards of an LSPIndex (the shard cutter).

The port of the JAX package's ``distributed/retrieval.py`` shard cutter
(``_pb_slice``, ``_pad_rows``, ``shards_of``, ``_local_index``,
``shard_index``); its shards are byte-equal to the JAX package's. Each shard
owns a contiguous range of superblocks (and their blocks and documents); the
last shard's ragged tail is padded with empty superblocks. The cut runs on
the index's device.

The JAX package cuts a packed bound matrix by unpacking it whole, slicing and
repacking. At a million documents the block matrix alone is 30,522 x 131,072
4-bit values, 16 GB as int32 (32 GB through the int64 of ``pack_rows_strided``),
so here each shard is cut on its own: where the shard starts and ends on a
packing granule (always for the block matrix, whose granule is one
superblock's c blocks) the words are sliced directly and the tail padded with
zero words; elsewhere (the superblock matrices, whose granule is 1,024
superblocks at 4 bits) only the granules the shard covers are unpacked, a
chunk of term rows at a time.
"""

from __future__ import annotations

import torch

from repro_torch.core.bounds import unpack_strided
from repro_torch.index.layout import LSPIndex, PackedBounds
from repro_torch.index.pack import pack_rows_strided, vals_per_word

_ROW_CHUNK = 2048  # term rows unpacked and repacked at a time


def _pb_slice(pb: PackedBounds, lo_unit: int, n_unit: int) -> PackedBounds:
    """Cut a packed bounds matrix to the unit range [lo_unit, lo_unit + n_unit).

    Units past ``pb.n`` (the ragged tail of the last shard) get zero bounds:
    a quantized zero bound means SBMax == 0 for any query, so a padded
    superblock can never out-rank a real one under the canonical (value
    desc, id asc) order (pad ids are the largest)."""
    g = pb.granule_words
    seg = g * vals_per_word(pb.bits)  # units a granule of g words holds
    packed = pb.packed
    n_words = packed.shape[1]
    out_words = -(-n_unit // seg) * g
    if lo_unit % seg == 0 and n_unit % seg == 0:
        w0 = lo_unit // seg * g
        words = packed[:, w0: w0 + out_words]
        if words.shape[1] < out_words:
            words = torch.cat([words, words.new_zeros((words.shape[0], out_words - words.shape[1]))], dim=1)
    else:
        s0 = lo_unit // seg  # the granules that hold the range
        s1 = min(-(-(lo_unit + n_unit) // seg), n_words // g)
        off = lo_unit - s0 * seg
        chunks = []
        for r in range(0, packed.shape[0], _ROW_CHUNK):
            vals = unpack_strided(packed[r: r + _ROW_CHUNK, s0 * g: s1 * g], pb.bits, g)
            vals = vals[:, off: off + n_unit].contiguous()
            if vals.shape[1] < n_unit:
                vals = torch.cat([vals, vals.new_zeros((vals.shape[0], n_unit - vals.shape[1]))], dim=1)
            chunks.append(pack_rows_strided(vals, pb.bits, g))
        words = torch.cat(chunks)
    return PackedBounds(words.contiguous(), pb.bits, pb.scale, n_unit, g)


def _pad_rows(a: torch.Tensor, n_rows: int, fill) -> torch.Tensor:
    """Pad the leading axis of ``a`` to ``n_rows`` with ``fill``."""
    if a.shape[0] >= n_rows:
        return a
    wide = a.to(torch.int32) if a.dtype == torch.uint16 else a  # CUDA has no uint16 cat
    pad = wide.new_full((n_rows - a.shape[0], *a.shape[1:]), fill)
    return torch.cat([wide, pad]).to(a.dtype)


def shards_of(n_superblocks: int, n_shards: int) -> int:
    """Per-shard superblock count: ceil(NS / P). The last shard's tail is padded
    with empty superblocks so any corpus size shards evenly."""
    return -(-n_superblocks // n_shards)


def _local_index(index: LSPIndex, shard: int, n_shards: int) -> LSPIndex:
    ns_l = shards_of(index.n_superblocks, n_shards)
    nb_l = ns_l * index.c
    nd_l = nb_l * index.b
    s0, b0, d0 = shard * ns_l, shard * nb_l, shard * nd_l
    fq = index.docs_fwdq
    # ragged tail: padded blocks hold sentinel terms (id == vocab, weight 0) and
    # padded doc positions remap to the n_docs sentinel: they score NEG everywhere
    remap = _pad_rows(index.doc_remap[d0: d0 + nd_l], nd_l, index.n_docs)
    fq_tids = _pad_rows(fq.tids[b0: b0 + nb_l], nb_l, index.vocab)
    fq_ws = _pad_rows(fq.ws[b0: b0 + nb_l], nb_l, 0)
    fq_scales = _pad_rows(fq.scales[b0: b0 + nb_l], nb_l, 1.0)
    return LSPIndex(
        b=index.b,
        c=index.c,
        n_docs=index.n_docs,  # global doc count (remap validity is global)
        vocab=index.vocab,
        n_blocks=nb_l,
        n_superblocks=ns_l,
        sb_bounds=_pb_slice(index.sb_bounds, s0, ns_l),
        blk_bounds=_pb_slice(index.blk_bounds, b0, nb_l),
        sb_avg=None if index.sb_avg is None else _pb_slice(index.sb_avg, s0, ns_l),
        docs_fwd=None,  # scoring reads docs_fwdq only; the big layout is not duplicated
        docs_flat=None,  # the sharded path uses the fwd layout
        doc_remap=remap,
        docs_fwdq=fq._replace(tids=fq_tids, ws=fq_ws, scales=fq_scales),
        docs_flatq=None,
    )


def shard_index(index: LSPIndex, n_shards: int) -> list[LSPIndex]:
    """Contiguous superblock-range shards, on the index's device; the last
    shard's ragged tail (when NS % n_shards != 0) is padded with empty
    superblocks that score NEG."""
    return [_local_index(index, s, n_shards) for s in range(n_shards)]
