"""Contiguous superblock-range shards of an LSPIndex, and retrieval that runs
the whole pipeline per shard.

The port of the JAX package's ``distributed/retrieval.py``. The shard cutter
(``_pb_slice``, ``_pad_rows``, ``shards_of``, ``_local_index``,
``shard_index``) gives shards byte-equal to the JAX package's. Each shard
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

``retrieve_distributed`` (host loop) and ``make_mesh_retriever`` (one
process-group rank per shard) run the full LSP pipeline on every shard at the
same γ and merge canonically: rank-safe (the union of per-shard top-γ covers
the global top-γ), but not equal to one device, since each shard seeds its own
θ, and a binding ``block_budget`` applies per shard. The equal split is
``distributed/sharded.py``'s ``ShardedRetriever``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.bounds import unpack_strided
from repro_torch.core.config import RetrievalConfig
from repro_torch.core.lsp import search_retrieve
from repro_torch.core.query import QueryBatch
from repro_torch.core.scoring import NEG
from repro_torch.distributed.topk import all_gather_cat, merge_shard_results
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


def _shard_result(shard: LSPIndex, qb: QueryBatch, cfg: RetrievalConfig, impl: str):
    res = search_retrieve(shard, qb, cfg.static(), cfg.dynamic(), impl=impl)
    return torch.where(res.doc_ids >= 0, res.scores, NEG), res.doc_ids


def retrieve_distributed(shards: list[LSPIndex], qb: QueryBatch, cfg: RetrievalConfig, impl: str = "ref"):
    """Host-loop counterpart of ``make_mesh_retriever``: the full pipeline on
    every shard, then the canonical merge. Returns (ids [Q, k], scores [Q, k])."""
    parts = [_shard_result(sh, qb, cfg, impl) for sh in shards]
    scores = torch.cat([p[0] for p in parts], dim=1)
    return merge_shard_results(scores, torch.cat([p[1] for p in parts], dim=1), cfg.k)


class StackedShards:
    """Per-shard tensors stacked on a leading shard axis; ``local(p)`` is shard
    p's LSPIndex over them (scoring reads the fwd operand only; no ``sb_avg``,
    as in the JAX package's stacked shards)."""

    def __init__(self, shards: list[LSPIndex]):
        self.meta = shards[0]
        self.n_shards = len(shards)

        def st(get):
            return torch.stack([get(s) for s in shards])

        self.sb_packed = st(lambda s: s.sb_bounds.packed)
        self.blk_packed = st(lambda s: s.blk_bounds.packed)
        self.fwdq_tids = st(lambda s: s.docs_fwdq.tids)
        self.fwdq_ws = st(lambda s: s.docs_fwdq.ws)
        self.fwdq_scales = st(lambda s: s.docs_fwdq.scales)
        self.remap = st(lambda s: s.doc_remap)

    def local(self, p: int) -> LSPIndex:
        meta = self.meta
        return meta._replace(
            sb_bounds=meta.sb_bounds._replace(packed=self.sb_packed[p]),
            blk_bounds=meta.blk_bounds._replace(packed=self.blk_packed[p]),
            sb_avg=None,
            docs_fwd=None,
            docs_flat=None,
            doc_remap=self.remap[p],
            docs_fwdq=meta.docs_fwdq._replace(tids=self.fwdq_tids[p], ws=self.fwdq_ws[p], scales=self.fwdq_scales[p]),
            docs_flatq=None,
        )


def make_mesh_retriever(shards: list[LSPIndex], cfg: RetrievalConfig, group=None, impl: str = "auto"):
    """Process-group counterpart of the JAX ``shard_map`` retriever: rank r runs
    the full pipeline on shard r (``group`` has one rank per shard), the
    per-shard (score, id) lists are all-gathered over the group and merged
    canonically. Every rank calls ``run(qb)`` with the same batch; each gets
    (ids [Q, k], scores [Q, k]). Returns (run, the stacked shards)."""
    if dist.get_world_size(group) != len(shards):
        raise ValueError(f"a group of {dist.get_world_size(group)} ranks cannot serve {len(shards)} shards")
    stacked = StackedShards(shards)
    local = stacked.local(dist.get_rank(group))

    def run(qb: QueryBatch):
        scores, ids = _shard_result(local, qb, cfg, impl)
        return merge_shard_results(all_gather_cat(scores, group), all_gather_cat(ids, group), cfg.k)

    return run, stacked
