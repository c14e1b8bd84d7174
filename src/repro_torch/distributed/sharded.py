"""Sharded LSP serving: global pruning decisions, local scoring.

The port of the JAX package's ``distributed/sharded.py``. Running the whole
traversal per shard and merging (``distributed.retrieval.retrieve_distributed``)
is safe but not identical to one device: a shard with weak round-0 documents
seeds a lower θ and visits superblocks the global traversal would not. This
module splits the traversal so that every *decision* is global and every
*scoring gather* is local, which makes a sharded search equal to
``core.lsp.search_retrieve`` on the unsharded index (ids, θ, both visit
counters; scores up to float32 summation order):

  stage 1  per-shard SBMax over the shard's superblocks -> its top-budget_l
           candidates (``stable_topk``) -> canonical merge (value desc,
           global id asc) into THE global candidate list, which is the
           single-device ``stable_topk`` because ids are positions.
  stage 2  each shard scores its members of the global top-γ₀ (round 0,
           masked to what it owns); per-shard top-k score lists merge into
           the global θ (the k largest of a union lie in the union of the
           per-part k largest).
  stage 3  the variant's eligibility rule on the global (rank, value, θ)
           masked to owned superblocks; block BoundSums and the θ/η cut read
           only the shard's memory. With a binding ``block_budget``
           (< budget·c) each shard's canonical top-block_budget (bound desc,
           global block id asc) merges into the global cutoff pair, and every
           shard keeps its blocks at or before it (``canonical_keep_mask``),
           ties straddling shards included. Scoring reads only local memory;
           local canonical top-k_max -> gather [Q, P·k_max] -> final top-k.

Every kernel launch reads only what its shard owns: the round-0 scores take
the ownership mask and phase 2's block BoundSums the eligibility mask (already
``& owned``), and the masked kernels read no masked pair.

Two transports share the per-shard stages (``_traverse``), so they cannot
diverge:
  * host loop (``group=None``): every shard traversed in this process, on one
    device; the reference semantics;
  * process group (``group=``, the counterpart of the JAX ``shard_map``
    transport): one rank per shard, each holding only its own shard
    (``lo = rank · ns_l``); every ``lax.all_gather(..., "model", axis=1,
    tiled=True)`` becomes ``distributed.topk.all_gather_cat``. The ranks
    drive it together: each calls the retriever with the same batch and
    dynamic point, as the replicated queries of ``shard_map``.

Shapes come from ``StaticConfig`` and the dynamic (k, μ, η, β) ride as [Q]
tensors, as in ``core.lsp.search_retrieve``. BMP and exact (no superblock
level to shard on) and the flat layout (shards carry the fwd operand only)
are refused.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.core import ops
from repro_torch.core.config import DynamicArgs, DynamicParams, RetrievalConfig, StaticConfig, dynamic_args
from repro_torch.core.lsp import (
    _expand_superblocks,
    competitive_block_topk,
    make_dynamic_runner,
    mask_beyond_k,
    masked_kth_min,
    resolve_block_budget,
)
from repro_torch.core.query import QueryBatch, prune_terms, scatter_dense
from repro_torch.core.scoring import NEG, score_blocks
from repro_torch.core.topk import canonical_keep_mask, canonical_topk, stable_topk
from repro_torch.distributed.retrieval import _local_index, shard_index
from repro_torch.distributed.topk import all_gather_cat
from repro_torch.index.layout import LSPIndex, index_device


class ShardedRetrievalResult(NamedTuple):
    """RetrievalResult's five fields + per-shard pruning telemetry.

    ``shard_candidates`` is the load-balance counter: each shard's share of
    the global top-γ candidate list per query (they sum to min(γ, budget))."""

    doc_ids: torch.Tensor  # int32 [Q, k_max] original doc ids, -1 where no result
    scores: torch.Tensor  # float32 [Q, k_max]
    n_superblocks_visited: torch.Tensor  # int32 [Q] summed over shards (distinct)
    n_blocks_scored: torch.Tensor  # int32 [Q] summed over shards (distinct)
    theta: torch.Tensor  # float32 [Q] the global round-0 threshold
    shard_theta: torch.Tensor  # float32 [Q, P] per-shard local round-0 θ
    shard_superblocks: torch.Tensor  # int32 [Q, P] distinct superblocks per shard
    shard_blocks: torch.Tensor  # int32 [Q, P] distinct blocks per shard
    shard_candidates: torch.Tensor  # int32 [Q, P] share of the global top-γ per shard


class _Plan(NamedTuple):
    """Static widths shared by every shard (search_retrieve's locals)."""

    gamma: int
    g0: int
    budget: int  # global candidate-list width, clamped at the TRUE superblock count
    budget_l: int  # per-shard candidate contribution
    k_max: int  # widest dynamic k; sizes every k-dependent width
    width0: int  # round-0 score width g0*c*b (θ's clamp width)
    k_l: int  # per-shard θ contribution min(k_max, width0)
    ns_l: int  # per-shard (padded) superblock count
    n_shards: int
    block_budget: int  # phase-3 block cap (resolve_block_budget; == budget*c when unset)
    competitive: bool  # block_budget < budget*c: the cross-shard bounds merge runs


def make_plan(scfg: StaticConfig, ns_true: int, ns_l: int, c: int, b: int, n_shards: int) -> _Plan:
    gamma = min(scfg.gamma, ns_true)
    budget = min(scfg.resolved_sb_budget(), ns_true)
    g0 = min(scfg.gamma0, gamma, budget)
    width0 = g0 * c * b
    # the clamp the single-device traversal applies over its [Q, budget*c] width
    block_budget = resolve_block_budget(scfg, budget * c)
    return _Plan(
        gamma=gamma,
        g0=g0,
        budget=budget,
        budget_l=min(budget, ns_l),
        k_max=scfg.k_max,
        width0=width0,
        k_l=min(scfg.k_max, width0),
        ns_l=ns_l,
        n_shards=n_shards,
        block_budget=block_budget,
        competitive=block_budget < budget * c,
    )


# --------------------------------------------------------------- per-shard stages
# Functions of (local index, replicated global tensors): both transports run
# exactly this math.


def _phase1_local(local: LSPIndex, qb_pr: QueryBatch, impl: str, plan: _Plan):
    """Local SBMax + local top-budget_l candidates (ties by lower local id)."""
    sbmax_l = ops.sbmax(local.sb_bounds, qb_pr.tids, qb_pr.ws, impl)  # [Q, ns_l]
    return stable_topk(sbmax_l, plan.budget_l)


def _round0_local(local: LSPIndex, qdense, g_ids, lo: int, scfg: StaticConfig, impl: str, plan: _Plan):
    """Score the shard's members of the GLOBAL top-γ₀ superblocks; the kernel
    reads no block of a superblock another shard owns."""
    g0_ids = g_ids[:, : plan.g0]
    owned0 = (g0_ids >= lo) & (g0_ids < lo + plan.ns_l)
    loc0 = torch.clamp(g0_ids - lo, 0, plan.ns_l - 1)
    blk0 = _expand_superblocks(loc0, local.c)  # [Q, g0*c] local block ids
    mask0 = torch.repeat_interleave(owned0, local.c, dim=1)
    scores0, pos0 = score_blocks(local, qdense, blk0, mask0, scfg.doc_layout, impl)
    return owned0, loc0, scores0, pos0


def _local_theta(scores0: torch.Tensor, plan: _Plan, k: torch.Tensor) -> torch.Tensor:
    """The shard-local round-0 threshold (``_kth_threshold``'s clamp rule)."""
    vals = torch.topk(scores0, plan.k_l, dim=-1).values  # values only: tie order immaterial
    return masked_kth_min(vals, torch.clamp(k, max=plan.width0))


def merge_theta(theta_lists: torch.Tensor, plan: _Plan, k: torch.Tensor) -> torch.Tensor:
    """Global θ from the concatenated per-shard top-k_l round-0 score lists
    [Q, P*k_l]: the min over the top-min(k, width0) of the union, which is
    what ``_kth_threshold`` computes over the unsharded round-0 row (with k
    past the round-0 width both degrade to the row's minimum, clamped at 0).
    One merge width, k_l = min(k_max, width0), serves every dynamic k."""
    vals = torch.topk(theta_lists, min(plan.k_max, plan.width0), dim=-1).values
    return masked_kth_min(vals, torch.clamp(k, max=plan.width0))


class _Phase2(NamedTuple):
    """Per-shard phase-2 output: the η-cut block-bound candidates (flattened,
    with their GLOBAL block ids) plus what the accounting needs."""

    loc_idx: torch.Tensor  # int64 [Q, budget] clamped local candidate superblock ids
    eligible: torch.Tensor  # bool [Q, budget] ownership-masked eligibility
    owned: torch.Tensor  # bool [Q, budget] candidate ownership (load balance)
    flat_bounds: torch.Tensor  # float32 [Q, budget*c] η-cut bounds, NEG elsewhere
    flat_gids: torch.Tensor  # int64 [Q, budget*c] GLOBAL block ids of the flat slots


def _phase2_local(local: LSPIndex, lo: int, qb_pr: QueryBatch, g_vals, g_ids, theta, scfg: StaticConfig,
                  d: DynamicArgs, impl: str, plan: _Plan) -> _Phase2:
    """Eligibility at the global (rank, value, θ) + block BoundSums of the
    eligible owned candidates + the θ/η cut.

    ``flat_gids`` expands the GLOBAL candidate ids, so the per-shard (bound,
    gid) candidates are the single-device flat candidates partitioned by
    ownership: non-owned and η-cut slots are NEG and inert downstream."""
    c, ns_l = local.c, plan.ns_l
    rank = torch.arange(plan.budget, device=g_ids.device)[None, :]
    th = theta[:, None]
    mu = d.mu[:, None]
    eta = d.eta[:, None]
    owned = (g_ids >= lo) & (g_ids < lo + ns_l)
    loc_idx = torch.clamp(g_ids - lo, 0, ns_l - 1)
    in_gamma = (rank < plan.gamma) & (g_vals >= th)
    if scfg.variant == "lsp0":
        eligible = in_gamma
    elif scfg.variant == "lsp1":
        eligible = in_gamma | (g_vals > th / mu)
    elif scfg.variant in ("lsp2", "sp"):
        if local.sb_avg is None:
            raise ValueError(f"{scfg.variant} needs superblock averages in the index")
        sbavg_l = ops.sbmax(local.sb_avg, qb_pr.tids, qb_pr.ws, impl)  # [Q, ns_l]
        avg_vals = torch.gather(sbavg_l, 1, loc_idx)  # garbage where not owned
        sp_rule = (g_vals > th / mu) | (avg_vals > th / eta)
        eligible = (in_gamma | sp_rule) if scfg.variant == "lsp2" else sp_rule
    else:
        raise ValueError(f"unknown variant {scfg.variant!r}")
    if scfg.variant != "sp":
        eligible = eligible & (rank >= plan.g0)  # round 0 already scored these
    eligible = eligible & owned  # each shard prunes and scores only what it owns

    blk_bounds = ops.gathered_block_bounds(local.blk_bounds, c, qb_pr.tids, qb_pr.ws, loc_idx, eligible, impl)
    blk_bounds = torch.where(eligible[:, :, None], blk_bounds, NEG)  # [Q, budget, c]
    blk_keep = blk_bounds > th[:, :, None] / eta[:, :, None]
    flat_bounds = torch.where(blk_keep, blk_bounds, NEG).reshape(blk_bounds.shape[0], -1)
    flat_gids = _expand_superblocks(g_ids, c)  # == the single-device flat gids
    return _Phase2(loc_idx, eligible, owned, flat_bounds, flat_gids)


def _local_block_candidates(p2: _Phase2, plan: _Plan):
    """This shard's part of the cross-shard bounds merge: its canonical
    top-``block_budget`` (bound desc, global block id asc). A block outside
    the local top-budget is outside the global one a fortiori. The same
    ``competitive_block_topk`` the single-device cut runs."""
    return competitive_block_topk(p2.flat_bounds, p2.flat_gids, plan.block_budget)


def merge_block_cutoff(cat_vals: torch.Tensor, cat_gids: torch.Tensor, plan: _Plan):
    """Global block cutoff from the concatenated per-shard bound lists
    [Q, P·block_budget]: the budget-th (bound, id) pair of their canonical
    top-``block_budget``, which is the canonical top-k over every block that
    survived the η-cut. Block ids are globally unique, so masking each shard
    at this pair (``canonical_keep_mask``) keeps exactly the single-device
    selection, ties straddling shards included."""
    gv, gg = canonical_topk(cat_vals, cat_gids, plan.block_budget)
    return gv[:, -1], gg[:, -1]


def _phase3_local(local: LSPIndex, lo: int, qdense, p2: _Phase2, owned0, loc0, scores0, pos0, block_cut,
                  scfg: StaticConfig, d: DynamicArgs, impl: str, plan: _Plan):
    """Block selection (full width, or masked at the global competitive
    cutoff), local document scoring, local canonical top-k_max, and the
    distinct-visit and load-balance accounting ([Q, 3]: superblocks, blocks,
    top-γ candidates). ``block_cut`` is None (the
    θ/η cut is the only block filter) or this shard's (bounds, gids, mask)
    candidates plus the global (cut_val, cut_id) of ``merge_block_cutoff``."""
    c = local.c
    rank = torch.arange(plan.budget, device=loc0.device)[None, :]
    if scfg.variant == "sp":
        # SP: round 0 only seeds θ; its documents are not returned
        scores0 = torch.full_like(scores0, NEG)
    if block_cut is None:
        bvals, bidx = stable_topk(p2.flat_bounds, plan.budget * c)  # every η-cut survivor
        sel_sb = torch.gather(p2.loc_idx, 1, bidx // c)
        blk_ids = sel_sb * c + bidx % c
        blk_mask = bvals > NEG / 2
    else:
        lb_vals, lb_gids, lb_mask, cut_v, cut_id = block_cut
        # the owned members of the global top-block_budget: phase-3 width is
        # block_budget per shard, not budget*c
        blk_mask = lb_mask & canonical_keep_mask(lb_vals, lb_gids, cut_v, cut_id)
        blk_ids = torch.where(blk_mask, lb_gids - lo * c, 0)  # local block ids

    scores1, pos1 = score_blocks(local, qdense, blk_ids, blk_mask, scfg.doc_layout, impl)

    all_scores = torch.cat([scores0, scores1], dim=1)
    all_pos = torch.cat([pos0, pos1], dim=1)
    all_ids = local.doc_remap[torch.clamp(all_pos, 0, local.doc_remap.shape[0] - 1)]  # original doc ids
    vals_k, ids_k = canonical_topk(all_scores, all_ids, plan.k_max)
    live = vals_k > NEG / 2
    ids_k = torch.where(live, ids_k, -1)
    vals_k = torch.where(live, vals_k, NEG)

    # distinct-visit accounting, partitioned by ownership: summed over shards it
    # is the single-device count (each candidate has one owner, and the
    # competitive keep-set partitions the single-device one)
    n_owned0 = owned0.sum(dim=1)
    in_round0 = ((blk_ids[:, :, None] // c == loc0[:, None, :]) & owned0[:, None, :]).any(dim=2)
    n_blk = n_owned0 * c + (blk_mask & ~in_round0).sum(dim=1)
    n_sb = n_owned0 + (p2.eligible & (rank >= plan.g0)).sum(dim=1)
    # load balance: this shard's share of the global top-γ candidate list
    n_cand = (p2.owned & (rank < plan.gamma)).sum(dim=1)
    return ids_k, vals_k, torch.stack([n_sb, n_blk, n_cand], dim=1).to(torch.int32)


def _traverse(parts, gather, qb_full: QueryBatch, scfg: StaticConfig, d: DynamicArgs, impl: str,
              plan: _Plan) -> ShardedRetrievalResult:
    """The sharded traversal over the shards this process holds.

    ``parts`` is a list of (shard number p, local LSPIndex); ``gather`` takes
    one [Q, n] tensor per part and returns every shard's, concatenated on
    axis 1 in shard order (the host loop's ``torch.cat``, or the process
    group's all-gather). Every step between two gathers is per shard."""
    qb_pr = prune_terms(qb_full, d.beta)
    qdense = scatter_dense(qb_full)

    # stage 1: local candidates -> the global canonical candidate list
    s1 = [_phase1_local(s, qb_pr, impl, plan) for _, s in parts]
    vals_cat = gather([v for v, _ in s1])
    ids_cat = gather([(i + p * plan.ns_l).to(torch.int32) for (p, _), (_, i) in zip(parts, s1)])
    g_vals, g_ids = canonical_topk(vals_cat, ids_cat, plan.budget)
    g_ids = g_ids.long()

    # stage 2: round-0 scoring of the owned global-top-γ₀ members -> global θ
    r0 = [_round0_local(s, qdense, g_ids, p * plan.ns_l, scfg, impl, plan) for p, s in parts]
    q = qb_full.tids.shape[0]
    lists = gather([torch.cat([_local_theta(s0, plan, d.k)[:, None], torch.topk(s0, plan.k_l, dim=-1).values], dim=1)
                    for _, _, s0, _ in r0]).view(q, plan.n_shards, 1 + plan.k_l)  # θ_l + top-k_l, one gather
    shard_theta = lists[:, :, 0].contiguous()
    theta = merge_theta(lists[:, :, 1:].reshape(q, -1), plan, d.k)

    # stage 3: eligibility + block bounds + θ/η cut per shard
    p2s = [_phase2_local(s, p * plan.ns_l, qb_pr, g_vals, g_ids, theta, scfg, d, impl, plan) for p, s in parts]
    cuts = [None] * len(parts)
    if plan.competitive:
        # the cross-shard bounds merge: each shard's canonical top-block_budget
        # bound list joins into the global cutoff every shard masks its keep-set at
        lbs = [_local_block_candidates(p2, plan) for p2 in p2s]
        cut_v, cut_id = merge_block_cutoff(gather([lb[0] for lb in lbs]),
                                           gather([lb[1].to(torch.int32) for lb in lbs]), plan)
        cuts = [(*lb, cut_v, cut_id) for lb in lbs]

    # phase 3: block selection + scoring, local canonical top-k, final merge
    outs = [
        _phase3_local(s, p * plan.ns_l, qdense, p2, *r, cut, scfg, d, impl, plan)
        for (p, s), p2, r, cut in zip(parts, p2s, r0, cuts)
    ]
    fvals, fids = canonical_topk(gather([o[1] for o in outs]), gather([o[0] for o in outs]), plan.k_max)
    fvals, fids = mask_beyond_k(fvals, fids, d.k)
    counts = gather([o[2] for o in outs]).view(q, plan.n_shards, 3)  # the three counts, one gather
    n_sb, n_blk, n_cand = (counts[:, :, j].contiguous() for j in range(3))
    return ShardedRetrievalResult(
        doc_ids=fids,
        scores=fvals,
        n_superblocks_visited=n_sb.sum(dim=1, dtype=torch.int32),
        n_blocks_scored=n_blk.sum(dim=1, dtype=torch.int32),
        theta=theta,
        shard_theta=shard_theta,
        shard_superblocks=n_sb,
        shard_blocks=n_blk,
        shard_candidates=n_cand,
    )


def _host_cat(ts: list) -> torch.Tensor:
    return torch.cat(ts, dim=1)


def _split_cfg(cfg, dyn):
    """Accept the combined ``RetrievalConfig`` or the split ``StaticConfig``."""
    if isinstance(cfg, RetrievalConfig):
        return cfg.static(), (dyn if dyn is not None else cfg.dynamic())
    return cfg, dyn


def _validate(scfg: StaticConfig, impl: str) -> None:
    if scfg.variant not in ("lsp0", "lsp1", "lsp2", "sp"):
        raise ValueError(
            f"ShardedRetriever: variant {scfg.variant!r} has no superblock level to shard on"
            if scfg.variant in ("bmp", "exact")
            else f"unknown variant {scfg.variant!r}"
        )
    if scfg.doc_layout != "fwd":
        raise ValueError("ShardedRetriever: shards carry the fwd quantized operand only")
    if impl not in ops.IMPLS:
        raise ValueError(f"ShardedRetriever: impl must be one of {ops.IMPLS}, got {impl!r}")


# ------------------------------------------------------------------- host loop


def sharded_retrieve(
    shards: Sequence[LSPIndex],
    qb_full: QueryBatch,
    cfg: Union[RetrievalConfig, StaticConfig],
    impl: str = "auto",
    ns_true: Optional[int] = None,
    dyn=None,
) -> ShardedRetrievalResult:
    """Host-loop transport: every shard traversed in this process. Equal to
    ``search_retrieve`` on the unsharded index, and to the process-group
    transport. ``cfg`` is a ``StaticConfig`` (``dyn`` the dynamic point:
    ``DynamicParams``, a per-row list or ``DynamicArgs``) or a combined
    ``RetrievalConfig`` (its dynamic half is the default point). Pass the
    global ``ns_true`` for padded shards (the sum of the shards' counts
    otherwise)."""
    scfg, dyn = _split_cfg(cfg, dyn)
    meta = shards[0]
    ns_true = ns_true if ns_true is not None else sum(s.n_superblocks for s in shards)
    _validate(scfg, impl)
    plan = make_plan(scfg, ns_true, meta.n_superblocks, meta.c, meta.b, len(shards))
    d = dynamic_args(dyn, qb_full.tids.shape[0], scfg.k_max, qb_full.tids.device)
    return _traverse(list(enumerate(shards)), _host_cat, qb_full, scfg, d, impl, plan)


# ------------------------------------------------------------------- retriever


class ShardedRetriever:
    """Engine-pluggable sharded retriever: ``retriever(QueryBatch[, dyn]) ->
    ShardedRetrievalResult``, equal to the single-device traversal at the same
    (static, dynamic) point. Takes an unsharded ``LSPIndex`` with
    ``n_shards`` (cut here, on the index's device), a ``store.ShardedIndex``
    (its ``n_superblocks`` is the true global count) or a list of shards
    (pass ``ns_true``: shard padding hides it; the per-shard sum otherwise).

    ``group=None`` runs the host loop. ``group=`` a ``torch.distributed``
    process group of ``n_shards`` ranks runs the process-group transport
    (the counterpart of the JAX ``mesh=`` with a ``model`` axis): rank r
    serves shard r, and given a shard list or a ``ShardedIndex`` it reads
    only entry r, so the other entries may be None (``from_dir`` loads only
    the rank's own shard). Every rank calls the retriever with the same
    batch and dynamic point.

    The dynamic-runner contract of ``core.lsp.make_dynamic_runner``:
    ``warmup(shapes)``, ``n_traces()`` (0: nothing is compiled),
    ``supports_dynamic``, ``static_cfg``, ``defaults``, ``vocab`` and
    ``device`` (where the serving engine builds each batch)."""

    supports_dynamic = True

    def __init__(
        self,
        index_or_shards,
        cfg: Union[RetrievalConfig, StaticConfig],
        n_shards: Optional[int] = None,
        group=None,
        impl: str = "auto",
        ns_true: Optional[int] = None,
        defaults: Optional[DynamicParams] = None,
    ):
        scfg, default_dyn = _split_cfg(cfg, defaults)
        _validate(scfg, impl)
        rank = None if group is None else dist.get_rank(group)
        if isinstance(index_or_shards, LSPIndex):
            if not n_shards:
                if group is None:
                    raise ValueError("ShardedRetriever: n_shards is required with an unsharded index")
                n_shards = dist.get_world_size(group)
            ns_true = index_or_shards.n_superblocks
            if group is None:
                shards = shard_index(index_or_shards, n_shards)
            else:  # cut this rank's shard only
                shards = [None] * n_shards
                shards[rank] = _local_index(index_or_shards, rank, n_shards)
        elif hasattr(index_or_shards, "shards"):  # index.store.ShardedIndex
            shards = list(index_or_shards.shards)
            ns_true = index_or_shards.n_superblocks
        else:
            shards = list(index_or_shards)
        if group is None:
            lead = shards[0]
        else:
            if dist.get_world_size(group) != len(shards):
                raise ValueError(f"ShardedRetriever: a group of {dist.get_world_size(group)} ranks "
                                 f"cannot serve {len(shards)} shards")
            lead = shards[rank]
            if lead is None:
                raise ValueError(f"ShardedRetriever: rank {rank} was given no shard {rank}")
        if ns_true is None:
            ns_true = len(shards) * lead.n_superblocks  # the shards' sum: exact iff unpadded
        self.shards = shards
        self.n_shards = len(shards)
        self.static_cfg = scfg
        self.cfg = cfg  # as passed
        self.defaults = (default_dyn or DynamicParams(k=scfg.k_max)).validate_for(scfg)
        self.impl = impl
        self.ns_true = ns_true
        self.vocab = lead.vocab
        self.group = group
        self.device = index_device(lead)
        plan = make_plan(scfg, ns_true, lead.n_superblocks, lead.c, lead.b, self.n_shards)
        if group is None:
            parts, gather = list(enumerate(shards)), _host_cat
        else:
            parts = [(rank, lead)]

            def gather(ts):
                return all_gather_cat(ts[0], group)

        def fn(tids, ws, d):
            return _traverse(parts, gather, QueryBatch(tids, ws, self.vocab), scfg, d, impl, plan)

        self._run = make_dynamic_runner(fn, scfg, self.defaults, self.vocab, self.device)

    def __call__(self, qb: QueryBatch, dyn=None) -> ShardedRetrievalResult:
        return self._run(qb, dyn)

    def n_traces(self) -> int:
        return self._run.n_traces()

    def warmup(self, shapes) -> None:
        """Run every (Q, nq) bucket shape once with sentinel-only queries."""
        self._run.warmup(shapes)

    @classmethod
    def from_dir(cls, directory: str, cfg, group=None, impl: str = "auto", defaults=None, mmap: bool = True,
                 device=None) -> "ShardedRetriever":
        """Serve a persisted sharded set (``index.store.save_sharded_index``)
        from ``device`` (CUDA by default). With ``group`` each rank loads only
        its own shard, held to its fingerprint in the parent manifest."""
        from repro_torch.index.store import load_index_auto, load_shard_of

        if group is None:
            return cls(load_index_auto(directory, mmap=mmap, device=device), cfg, impl=impl, defaults=defaults)
        return cls(load_shard_of(directory, dist.get_rank(group), mmap=mmap, device=device), cfg, group=group,
                   impl=impl, defaults=defaults)
