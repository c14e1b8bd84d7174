"""Dense-embedding LSP: superblock pruning for dot-product retrieval over dense
candidate embeddings (recsys ``retrieval_cand``, MIND serving).

The port of the JAX package's ``core/lsp_dense.py``. A block
B's score bound for query q adapts Eq. 1 to signed vectors:

  Bound(q, B) = q+ . maxW(B) + q- . minW(B)

Per-dimension max/min are quantized outward (max up, min down) at 4 bits and
packed lane-strided, so the superblock bounds are two ``dequant_matmul``
products. The flow mirrors ``core/lsp.py``: superblock bounds -> top-γ
(+ μ for LSP/1) -> block bounds of the selected superblocks -> exact scoring
of the surviving blocks' candidates.

Tie order: the superblock candidate list and the block cut take indices, so
they use ``stable_topk`` (``jax.lax.top_k``'s lower-position rule); θ uses
values only; the final merge is ``canonical_topk`` (score desc, id asc).

Sharded (``shard_dense_index``, ``make_sharded_dense_retriever``): each shard
of contiguous superblocks prunes and scores its candidates with the full γ,
and the per-shard top-k merge canonically, in one process (the host loop) or
one process-group rank per shard (all-gathers of [B, P*k]).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import ops
from repro_torch.core.bounds import unpack_strided
from repro_torch.core.config import RetrievalConfig
from repro_torch.core.lsp import resolve_block_budget
from repro_torch.core.scoring import NEG
from repro_torch.core.topk import canonical_topk, stable_topk
from repro_torch.device import resolve_device
from repro_torch.distributed.topk import all_gather_cat, merge_shard_results
from repro_torch.index import clustering
from repro_torch.index.pack import SEG_WORDS, pack_rows_strided


class PackedMinMax(NamedTuple):
    max_packed: torch.Tensor  # int32 [D, W] (uint32 words)
    min_packed: torch.Tensor
    scale: torch.Tensor  # float32 [D] per-dimension dequant scale
    zero: torch.Tensor  # float32 [D] per-dimension zero point
    n: int  # logical columns (superblocks or blocks)
    granule_words: int
    bits: int


class DenseLSPIndex(NamedTuple):
    """Every tensor lives on one device."""

    b: int
    c: int
    n_cands: int
    dim: int
    n_blocks: int
    n_superblocks: int
    sb: PackedMinMax  # superblock per-dim max/min
    blk: PackedMinMax  # block per-dim max/min (superblock-contiguous)
    cands: torch.Tensor  # bfloat16 [n_pad, D] block-ordered candidate embeddings
    remap: torch.Tensor  # int32 [n_pad] position -> original candidate id (n_cands = padding)


@dataclass(frozen=True)
class DenseIndexConfig:
    b: int = 64
    c: int = 16
    bits: int = 4
    kmeans_iters: int = 6
    seed: int = 0
    ns_align: int = 1  # pad n_superblocks to this multiple

    def __post_init__(self) -> None:
        if (self.c * self.bits) % 32:
            raise ValueError(f"c * bits must be a multiple of 32 (one block granule of whole words), "
                             f"got c={self.c}, bits={self.bits}")


def _quant_minmax(mx: torch.Tensor, mn: torch.Tensor, bits: int, granule: int,
                  scale_zero: tuple[float, float] | None = None) -> PackedMinMax:
    """Per-dimension affine quantization of the float32 [D, N] max/min bound
    rows, max rounded up and min down so the bounds stay valid. The scales fold
    into the query at search time, the zero point is one q . zero product.
    ``scale_zero`` fixes one (scale, zero) for every dimension instead of each
    dimension's own range; values outside it clamp to the end levels."""
    levels = (1 << bits) - 1
    if scale_zero is None:
        lo = mn.amin(dim=1, keepdim=True)
        hi = mx.amax(dim=1, keepdim=True)
        scale = torch.clamp((hi - lo) / levels, min=1e-9)
        zero = lo
    else:
        scale, zero = (torch.full((mx.shape[0], 1), v, dtype=torch.float32, device=mx.device) for v in scale_zero)
    qmax = torch.clamp(torch.ceil((mx - zero) / scale - 1e-9), 0, levels).to(torch.uint8)
    qmin = torch.clamp(torch.floor((mn - zero) / scale + 1e-9), 0, levels).to(torch.uint8)
    return PackedMinMax(pack_rows_strided(qmax, bits, granule), pack_rows_strided(qmin, bits, granule),
                        scale[:, 0].contiguous(), zero[:, 0].contiguous(), mx.shape[1], granule, bits)


def dense_order(cands: torch.Tensor, cfg: DenseIndexConfig) -> torch.Tensor:
    """The build's candidate order (int64 [n]): k-means over the L2-normalized
    float32 embeddings [n, D] into n // (b*c) clusters, then by (cluster's
    rank in the centroid chain, distance to its centroid)."""
    n = cands.shape[0]
    if n <= cfg.b:
        return torch.arange(n, device=cands.device)
    norm = cands / torch.clamp(torch.linalg.vector_norm(cands, dim=1, keepdim=True), min=1e-9)
    return clustering.cluster_order(norm, max(1, n // (cfg.b * cfg.c)), cfg.kmeans_iters, cfg.seed)


def build_dense_index(cands: Union[np.ndarray, torch.Tensor], cfg: DenseIndexConfig,
                      device=None, scale_zero: tuple[float, float] | None = None) -> DenseLSPIndex:
    """Build the dense index of float32 embeddings [n, D] on ``device`` (CUDA
    by default); ``scale_zero`` fixes the bounds' quantizer (``_quant_minmax``)."""
    device = resolve_device(device)
    if isinstance(cands, torch.Tensor):
        x_in = cands.to(device, torch.float32)
    else:
        x_in = torch.from_numpy(np.ascontiguousarray(cands, np.float32)).to(device)
    n, d = x_in.shape
    b, c = cfg.b, cfg.c
    order = dense_order(x_in, cfg)
    ns = -(-n // (b * c))
    ns = -(-ns // cfg.ns_align) * cfg.ns_align
    n_pad = ns * b * c
    nb = n_pad // b
    remap = torch.cat([order, torch.full((n_pad - n,), n, dtype=order.dtype, device=device)]).to(torch.int32)

    x = torch.zeros((n_pad, d), dtype=torch.float32, device=device)
    x[:n] = x_in[order]
    xb = x.view(nb, b, d)
    # padded rows must not loosen the bounds: they are left out of the max/min
    valid = (remap < n).view(nb, b)
    blk_max = torch.where(valid[..., None], xb, -1e30).amax(dim=1).T.contiguous()  # [D, NB]
    blk_min = torch.where(valid[..., None], xb, 1e30).amin(dim=1).T.contiguous()
    empty = ~valid.any(dim=1)
    blk_max[:, empty] = 0.0
    blk_min[:, empty] = 0.0
    sb_max = blk_max.view(d, ns, c).amax(dim=2)
    sb_min = blk_min.view(d, ns, c).amin(dim=2)

    cw = c * cfg.bits // 32
    return DenseLSPIndex(
        b=b, c=c, n_cands=n, dim=d, n_blocks=nb, n_superblocks=ns,
        sb=_quant_minmax(sb_max, sb_min, cfg.bits, SEG_WORDS, scale_zero),
        blk=_quant_minmax(blk_max, blk_min, cfg.bits, cw, scale_zero),
        cands=x.to(torch.bfloat16),
        remap=remap,
    )


def _bounds(pm: PackedMinMax, q: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """[B, n] upper bounds q+ . maxW + q- . minW, zero-point corrected. The
    per-dimension scales fold into the query rows, so the two dequant GEMMs
    stay scale-free."""
    qs = q * pm.scale
    qp = torch.clamp(qs, min=0.0)
    qm = torch.clamp(qs, max=0.0)
    raw = (ops.dequant_matmul(qp, pm.max_packed, pm.bits, pm.n, impl=impl)
           + ops.dequant_matmul(qm, pm.min_packed, pm.bits, pm.n, impl=impl))
    return raw + (q * pm.zero).sum(dim=1, keepdim=True)


def _score_positions(index: DenseLSPIndex, q: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Exact scores of the candidates at positions pos [B, P]; padding scores NEG."""
    pos_c = torch.clamp(pos, 0, index.remap.shape[0] - 1)
    s = torch.einsum("bpd,bd->bp", index.cands[pos_c].to(torch.float32), q)
    return torch.where(index.remap[pos_c] < index.n_cands, s, NEG)


def _as_queries(index: DenseLSPIndex, q) -> torch.Tensor:
    return torch.as_tensor(q, dtype=torch.float32, device=index.remap.device)


def retrieve_dense(index: DenseLSPIndex, q, cfg: RetrievalConfig, impl: str = "auto"):
    """q [B, D] -> (candidate ids int32 [B, k], -1 where none; scores [B, k]).
    LSP/0 semantics, or LSP/1 for ``cfg.variant == "lsp1"``."""
    q = _as_queries(index, q)
    bq = q.shape[0]
    dev = q.device
    ns, c, b = index.n_superblocks, index.c, index.b
    gamma = min(cfg.gamma, ns)
    g0 = min(cfg.gamma0, gamma)
    budget = min(cfg.resolved_sb_budget(), ns)

    sb_bound = _bounds(index.sb, q, impl)  # [B, NS]
    top_vals, top_idx = stable_topk(sb_bound, budget)

    # round 0: exact scores of the top-γ0 superblocks' candidates seed θ
    span = c * b
    pos0 = (top_idx[:, :g0, None] * span + torch.arange(span, device=dev)[None, None, :]).reshape(bq, -1)
    s0 = _score_positions(index, q, pos0)
    theta = torch.topk(s0, min(cfg.k, s0.shape[1]), dim=1).values.amin(dim=1)  # values only

    rank = torch.arange(budget, device=dev)[None, :]
    th = theta[:, None]
    eligible = (rank < gamma) & (top_vals >= th)
    if cfg.variant == "lsp1":
        eligible = eligible | (top_vals > th / cfg.mu)
    eligible = eligible & (rank >= g0)

    # block bounds of the selected superblocks (granule cw words each)
    blk = index.blk
    cw = c * blk.bits // 32
    vmax = unpack_strided(blk.max_packed.view(index.dim, ns, cw)[:, top_idx].permute(1, 2, 0, 3), blk.bits, cw)
    vmin = unpack_strided(blk.min_packed.view(index.dim, ns, cw)[:, top_idx].permute(1, 2, 0, 3), blk.bits, cw)
    qs = q * blk.scale
    blk_bound = (
        torch.einsum("bd,bsdc->bsc", torch.clamp(qs, min=0.0), vmax.to(torch.float32))
        + torch.einsum("bd,bsdc->bsc", torch.clamp(qs, max=0.0), vmin.to(torch.float32))
    ) + (q * blk.zero).sum(dim=1)[:, None, None]  # [B, S, c]
    blk_bound = torch.where(eligible[:, :, None], blk_bound, NEG)
    keep = blk_bound > th[:, :, None] / cfg.eta
    flat = torch.where(keep, blk_bound, NEG).reshape(bq, -1)
    bvals, bidx = stable_topk(flat, resolve_block_budget(cfg, budget * c))
    blk_ids = torch.gather(top_idx, 1, bidx // c) * c + bidx % c
    pos1 = (blk_ids[:, :, None] * b + torch.arange(b, device=dev)[None, None, :]).reshape(bq, -1)
    s1 = _score_positions(index, q, pos1)
    s1 = torch.where(torch.repeat_interleave(bvals > NEG / 2, b, dim=1), s1, NEG)

    scores = torch.cat([s0, s1], dim=1)
    pos = torch.cat([pos0, pos1], dim=1)
    ids_all = index.remap[torch.clamp(pos, 0, index.remap.shape[0] - 1)]
    vals, ids = canonical_topk(scores, ids_all, cfg.k)
    return torch.where(vals > NEG / 2, ids, -1), vals


def _slice_minmax(pm: PackedMinMax, lo: int, n: int, granule: int) -> PackedMinMax:
    """Columns [lo, lo + n) of both packed matrices, repacked at ``granule``."""

    def cut(words):
        vals = unpack_strided(words, pm.bits, pm.granule_words)[:, lo: lo + n]
        return pack_rows_strided(vals.to(torch.uint8), pm.bits, granule)

    return PackedMinMax(cut(pm.max_packed), cut(pm.min_packed), pm.scale, pm.zero, n, granule, pm.bits)


def shard_dense_index(index: DenseLSPIndex, n_shards: int) -> list[DenseLSPIndex]:
    """Cut a dense index into ``n_shards`` contiguous superblock ranges (bounds
    repacked per shard; the candidate rows are views). The superblock count
    must divide evenly (``DenseIndexConfig.ns_align``)."""
    if index.n_superblocks % n_shards:
        raise ValueError(f"{index.n_superblocks} superblocks do not cut into {n_shards} equal shards; "
                         f"build with ns_align a multiple of {n_shards}")
    ns_l = index.n_superblocks // n_shards
    nb_l = ns_l * index.c
    np_l = nb_l * index.b
    cw = index.c * index.blk.bits // 32
    return [
        DenseLSPIndex(
            b=index.b, c=index.c, n_cands=index.n_cands, dim=index.dim, n_blocks=nb_l, n_superblocks=ns_l,
            sb=_slice_minmax(index.sb, s * ns_l, ns_l, SEG_WORDS),
            blk=_slice_minmax(index.blk, s * nb_l, nb_l, cw),
            cands=index.cands[s * np_l: (s + 1) * np_l],
            remap=index.remap[s * np_l: (s + 1) * np_l],
        )
        for s in range(n_shards)
    ]


def dense_local_fn(cfg: RetrievalConfig, impl: str = "auto"):
    """The per-shard body of the sharded dense retriever: ``local_fn(shard, q)
    -> (ids [B, k], scores [B, k], NEG where no id)``, ready for the
    canonical merge of ``distributed.topk.merge_shard_results``."""

    def local_fn(local: DenseLSPIndex, q):
        ids, vals = retrieve_dense(local, q, cfg, impl)
        return ids, torch.where(ids >= 0, vals, NEG)

    return local_fn


def make_sharded_dense_retriever(shards: list[DenseLSPIndex], cfg: RetrievalConfig, group=None,
                                 impl: str = "auto"):
    """Sharded dense LSP: each shard prunes and scores its candidate range
    with the full γ, then the per-shard top-k merge canonically (collectives
    of O(P*k) a row). ``group=None`` runs every shard in this process (the
    host loop); a process group of one rank per shard runs rank r on
    ``shards[r]`` (the other entries may be None) with all-gathers, and every
    rank calls ``run(q)`` with the same rows. Returns ``run(q) -> (ids [B,
    k], scores [B, k])``."""
    local_fn = dense_local_fn(cfg, impl)
    if group is None:
        def run(q):
            parts = [local_fn(s, q) for s in shards]
            ids = torch.cat([p[0] for p in parts], dim=1)
            return merge_shard_results(torch.cat([p[1] for p in parts], dim=1), ids, cfg.k)
        return run
    if dist.get_world_size(group) != len(shards):
        raise ValueError(f"a group of {dist.get_world_size(group)} ranks cannot serve {len(shards)} shards")
    own = shards[dist.get_rank(group)]

    def run_group(q):
        ids, vals = local_fn(own, q)
        return merge_shard_results(all_gather_cat(vals, group), all_gather_cat(ids, group), cfg.k)

    return run_group


def retrieve_dense_exact(index: DenseLSPIndex, q, k: int):
    """Exhaustive scoring of every candidate, canonical top-k (score desc, id
    asc) -> (ids int32 [B, k], scores [B, k]): the recall oracle."""
    q = _as_queries(index, q)
    s = torch.einsum("nd,bd->bn", index.cands.to(torch.float32), q)
    s = torch.where((index.remap < index.n_cands)[None, :], s, NEG)
    vals, ids = canonical_topk(s, index.remap[None, :].expand_as(s), k)
    return torch.where(vals > NEG / 2, ids, -1), vals
