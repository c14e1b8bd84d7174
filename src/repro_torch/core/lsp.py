"""LSP/0, LSP/1, LSP/2, SP and the BMP baseline: batched, fixed-width traversal.

The port of the JAX package's ``core/lsp.py``, with the same two-round scheme:

  round 0  score all documents of the top-γ₀ superblocks; θ = k-th best score.
  round 1  apply the variant's superblock rule with θ, compute block
           BoundSums of the surviving superblocks, prune blocks at θ/η and
           score the rest.

Variant rules over the SBMax-sorted candidate list:
  LSP/0  top-γ superblocks with SBMax >= θ.
  LSP/1  LSP/0 ∪ { X : SBMax(X) > θ/μ }.
  LSP/2  LSP/0 ∪ { X : SBMax(X) > θ/μ or SBavg(X) > θ/η }.
  SP     { X : SBMax(X) > θ/μ or SBavg(X) > θ/η } (no guaranteed visits).
  BMP    no superblock level: BoundSum over all blocks, prune at θ/η.

Every site whose top-k *indices* are used ties by lower position, as
``jax.lax.top_k`` does (``topk.stable_topk``); the final selections use the
canonical (score desc, id asc) order. Results therefore match the JAX
package's ids and counters, with scores equal up to float32 summation order.

impl: "auto" | "ref" | "kernel", as in ``core.ops``, plus "legacy": the
profiling baseline from before the document-scoring kernels. Its bounds run
at "ref", both scoring rounds gather the selected blocks' documents by
position (``scoring.score_positions_fwd``) whatever the layout, and θ is the
last lane of the top-k_max list (the static point k = k_max only).
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import torch

from repro_torch.core import ops
from repro_torch.core.config import Dynamic, DynamicArgs, DynamicParams, StaticConfig, dynamic_args
from repro_torch.core.graphs import ShapeGraphs, graphs_engage
from repro_torch.core.query import QueryBatch, prune_terms, scatter_dense
from repro_torch.core.scoring import NEG, score_blocks, score_positions_fwd
from repro_torch.core.topk import canonical_topk, stable_topk
from repro_torch.index.layout import LSPIndex, _tensors, index_device


class RetrievalResult(NamedTuple):
    doc_ids: torch.Tensor  # int32 [Q, k_max] original doc ids, -1 where no result
    scores: torch.Tensor  # float32 [Q, k_max]
    n_superblocks_visited: torch.Tensor  # int32 [Q]
    n_blocks_scored: torch.Tensor  # int32 [Q]
    theta: Optional[torch.Tensor] = None  # float32 [Q] round-0 pruning threshold


def masked_kth_min(vals: torch.Tensor, k_sel: torch.Tensor) -> torch.Tensor:
    """Min over the first k_sel lanes of a descending top-k list [Q, W]: the
    per-row k_sel-th value, clamped at 0."""
    sel = torch.arange(vals.shape[-1], device=vals.device)[None, :] < k_sel[:, None]
    return torch.clamp(torch.where(sel, vals, float("inf")).amin(dim=-1), min=0.0)


def _kth_threshold(scores: torch.Tensor, k: torch.Tensor, k_max: int, legacy: bool = False) -> torch.Tensor:
    """θ = the row's k-th best score (0 if fewer than k valid docs); under
    ``legacy`` the k_max-th, from the last lane of the top list."""
    width = scores.shape[-1]
    vals = torch.topk(scores, min(k_max, width), dim=-1).values  # values only: tie order immaterial
    if legacy:
        return torch.clamp(vals[:, -1], min=0.0)
    return masked_kth_min(vals, torch.clamp(k, max=width))


def mask_beyond_k(vals: torch.Tensor, ids: torch.Tensor, k: torch.Tensor):
    """Finalize a canonical top-k_max selection: slots with no candidate and
    slots at rank >= the row's k become (NEG, -1). Returns (scores, ids)."""
    valid = (vals > NEG / 2) & (torch.arange(vals.shape[-1], device=vals.device)[None, :] < k[:, None])
    return torch.where(valid, vals, NEG), torch.where(valid, ids, -1)


def _expand_superblocks(sb_idx: torch.Tensor, c: int) -> torch.Tensor:
    """Superblock ids [Q, S] -> their block ids [Q, S*c]."""
    blk = sb_idx[:, :, None] * c + torch.arange(c, device=sb_idx.device)[None, None, :]
    return blk.reshape(blk.shape[0], -1)


def resolve_block_budget(scfg: StaticConfig, cand_blocks: int, default: int = 0) -> int:
    """The phase-3 block cap: an explicit ``block_budget`` (or the variant's
    default when unset), never wider than the candidate width in blocks."""
    bb = scfg.block_budget or (default or cand_blocks)
    return min(bb, cand_blocks)


def competitive_block_topk(flat_bounds: torch.Tensor, flat_gids: torch.Tensor, block_budget: int):
    """The competitive block cut: top-``block_budget`` candidates under the
    canonical (bound desc, block-id asc) order. Returns (bounds, block_ids,
    mask); masked slots get block id 0."""
    bvals, gids = canonical_topk(flat_bounds, flat_gids, block_budget)
    mask = bvals > NEG / 2
    return bvals, torch.where(mask, gids, 0).long(), mask


def _score_blocks_dispatch(index, qdense, blk_ids, blk_mask, scfg: StaticConfig, impl: str):
    """Both scoring rounds: through ``score_blocks``, or under "legacy" by
    the positions of the blocks' documents, masked blocks scoring NEG."""
    if impl != "legacy":
        return score_blocks(index, qdense, blk_ids, blk_mask, scfg.doc_layout, impl)
    b = index.b
    pos = (blk_ids[:, :, None] * b + torch.arange(b, device=blk_ids.device)[None, None, :]).reshape(
        blk_ids.shape[0], -1)
    scores = score_positions_fwd(index, qdense, pos)
    return torch.where(torch.repeat_interleave(blk_mask, b, dim=1), scores, NEG), pos


IMPLS = ops.IMPLS + ("legacy",)


def _merge_rounds(index, scfg, d, scores0, pos0, scores1, pos1):
    """Canonical (score desc, doc-id asc) top-k over both scoring rounds."""
    all_scores = torch.cat([scores0, scores1], dim=1)
    all_pos = torch.cat([pos0, pos1], dim=1)
    all_ids = index.doc_remap[torch.clamp(all_pos, 0, index.doc_remap.shape[0] - 1)]
    vals, ids = canonical_topk(all_scores, all_ids, scfg.k_max)
    return mask_beyond_k(vals, ids, d.k)


def search_retrieve(
    index: LSPIndex,
    qb_full: QueryBatch,
    scfg: StaticConfig,
    dyn: Dynamic = None,
    impl: str = "auto",
) -> RetrievalResult:
    """The traversal: widths from ``scfg``, per-row (k, μ, η, β) from ``dyn``
    (host params are broadcast; ``None`` means k = k_max). Result tensors are
    [Q, k_max], each row masked at its own k."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if isinstance(dyn, DynamicParams):
        dyn.validate_for(scfg)
    dev = qb_full.tids.device
    d = dynamic_args(dyn, qb_full.tids.shape[0], scfg.k_max, dev)
    variant = scfg.variant
    if variant == "exact":
        raise ValueError("variant 'exact' has no pruned traversal; use the 'exact' backend "
                         "or core.exact.retrieve_exact")
    ops.scoring_operand(index, scfg.doc_layout)  # a missing operand fails here, not mid-search
    if variant == "bmp":
        return _retrieve_bmp(index, qb_full, scfg, d, impl)

    bounds_impl = "ref" if impl == "legacy" else impl
    ns, c = index.n_superblocks, index.c
    gamma = min(scfg.gamma, ns)
    budget = min(scfg.resolved_sb_budget(), ns)
    # an sb_budget below γ0 caps round 0 too (the candidate list is only budget wide)
    g0 = min(scfg.gamma0, gamma, budget)
    qb = prune_terms(qb_full, d.beta)
    qdense = scatter_dense(qb_full)

    # ---- phase 1: superblock bounds, full sorted candidate list
    sbmax = ops.sbmax(index.sb_bounds, qb.tids, qb.ws, bounds_impl)  # [Q, NS]
    top_vals, top_idx = stable_topk(sbmax, budget)

    # ---- round 0: seed θ from the guaranteed head of the list
    blk0 = _expand_superblocks(top_idx[:, :g0], c)
    ones = torch.ones_like(blk0, dtype=torch.bool)
    scores0, pos0 = _score_blocks_dispatch(index, qdense, blk0, ones, scfg, impl)
    theta = _kth_threshold(scores0, d.k, scfg.k_max, legacy=impl == "legacy")  # [Q]

    # ---- variant eligibility over ranks [g0, budget)
    rank = torch.arange(budget, device=dev)[None, :]
    th = theta[:, None]
    mu = d.mu[:, None]
    eta = d.eta[:, None]
    in_gamma = (rank < gamma) & (top_vals >= th)
    if variant == "lsp0":
        eligible = in_gamma
    elif variant == "lsp1":
        eligible = in_gamma | (top_vals > th / mu)
    else:
        assert index.sb_avg is not None, f"{variant} needs superblock averages in the index"
        sbavg = ops.sbmax(index.sb_avg, qb.tids, qb.ws, bounds_impl)
        avg_vals = torch.gather(sbavg, 1, top_idx)
        sp_rule = (top_vals > th / mu) | (avg_vals > th / eta)
        eligible = (in_gamma | sp_rule) if variant == "lsp2" else sp_rule
    if variant == "sp":
        # SP has no guaranteed visits: round 0 only seeds θ, its documents are not returned
        scores0 = torch.full_like(scores0, NEG)
    else:
        eligible = eligible & (rank >= g0)  # round 0 already scored these

    # ---- phase 2: block bounds of the surviving superblocks, prune at θ/η
    blk_bounds = ops.gathered_block_bounds(index.blk_bounds, c, qb.tids, qb.ws, top_idx, eligible, bounds_impl)
    blk_bounds = torch.where(eligible[:, :, None], blk_bounds, NEG)  # [Q, budget, c]
    blk_keep = blk_bounds > th[:, :, None] / eta[:, :, None]
    flat_bounds = torch.where(blk_keep, blk_bounds, NEG).reshape(blk_bounds.shape[0], -1)
    block_budget = resolve_block_budget(scfg, budget * c)
    if block_budget < budget * c:
        # binding budget: canonical cut on (bound desc, global block-id asc)
        _, blk_ids, blk_mask = competitive_block_topk(
            flat_bounds, _expand_superblocks(top_idx, c), block_budget
        )
    else:
        # full width: the θ/η cut is the only block filter
        bvals, bidx = stable_topk(flat_bounds, block_budget)
        blk_ids = torch.gather(top_idx, 1, bidx // c) * c + bidx % c
        blk_mask = bvals > NEG / 2

    # ---- phase 3: document scoring, then the canonical merge of both rounds
    scores1, pos1 = _score_blocks_dispatch(index, qdense, blk_ids, blk_mask, scfg, impl)
    vals, ids = _merge_rounds(index, scfg, d, scores0, pos0, scores1, pos1)

    # ---- accounting: distinct blocks and superblocks only (sp may re-select
    # round-0 superblocks; those are re-scores, not new visits)
    in_round0 = (blk_ids[:, :, None] // c == top_idx[:, None, :g0]).any(dim=2)
    n_blocks_scored = g0 * c + (blk_mask & ~in_round0).sum(dim=1)
    n_sb_new = (eligible & (rank >= g0)).sum(dim=1)
    return RetrievalResult(
        doc_ids=ids,
        scores=vals,
        n_superblocks_visited=(g0 + n_sb_new).to(torch.int32),
        n_blocks_scored=n_blocks_scored.to(torch.int32),
        theta=theta,
    )


def _retrieve_bmp(
    index: LSPIndex, qb_full: QueryBatch, scfg: StaticConfig, d: DynamicArgs, impl: str
) -> RetrievalResult:
    """BMP baseline: single-level block filtering over all blocks. The
    round-0 block count is sized by the static k_max."""
    nb, b = index.n_blocks, index.b
    qb = prune_terms(qb_full, d.beta)
    qdense = scatter_dense(qb_full)

    boundsum = ops.sbmax(index.blk_bounds, qb.tids, qb.ws, "ref" if impl == "legacy" else impl)  # [Q, NB]
    b0 = min(max(scfg.gamma0 * index.c, scfg.k_max // b + 1), nb)
    budget = resolve_block_budget(scfg, nb, default=4 * scfg.gamma * index.c)
    # one stable sort serves both cuts: each is a prefix of the same order
    vals, idx = stable_topk(boundsum, max(b0, budget))
    i0 = idx[:, :b0]
    ones = torch.ones_like(i0, dtype=torch.bool)
    scores0, pos0 = _score_blocks_dispatch(index, qdense, i0, ones, scfg, impl)
    theta = _kth_threshold(scores0, d.k, scfg.k_max, legacy=impl == "legacy")

    vals, idx = vals[:, :budget], idx[:, :budget]
    rank = torch.arange(budget, device=idx.device)[None, :]
    eligible = (vals > theta[:, None] / d.eta[:, None]) & (rank >= b0)
    scores1, pos1 = _score_blocks_dispatch(index, qdense, idx, eligible, scfg, impl)
    tvals, ids = _merge_rounds(index, scfg, d, scores0, pos0, scores1, pos1)
    return RetrievalResult(
        doc_ids=ids,
        scores=tvals,
        n_superblocks_visited=torch.zeros(ids.shape[0], dtype=torch.int32, device=ids.device),
        n_blocks_scored=(b0 + eligible.sum(dim=1)).to(torch.int32),
        theta=theta,
    )


def validate_dynamic(dyn: Dynamic, scfg: StaticConfig) -> None:
    """Host-side check of a dynamic point (or per-row list) against ``scfg`` (k <= k_max)."""
    if isinstance(dyn, DynamicParams):
        dyn.validate_for(scfg)
    elif isinstance(dyn, (list, tuple)):
        for p in dyn:
            p.validate_for(scfg)


def make_dynamic_runner(fn, scfg: StaticConfig, defaults: DynamicParams, vocab: int, device):
    """Wrap ``fn(tids, ws, d: DynamicArgs)`` into the backend contract every
    caller consumes: ``run(qb, dyn=None)`` with host-param validation and [Q]
    broadcasting, ``run.warmup(shapes)``, ``run.n_traces()`` and the
    ``supports_dynamic`` / ``static_cfg`` / ``defaults`` / ``vocab`` attributes.

    PyTorch runs eagerly: nothing is traced or compiled per batch shape, so
    ``n_traces()`` is always 0 and ``warmup`` only runs each shape once (which
    builds and loads the CUDA kernels on first use)."""

    def run(qb: QueryBatch, dyn: Dynamic = None):
        validate_dynamic(dyn, scfg)
        d = dynamic_args(defaults if dyn is None else dyn, qb.tids.shape[0], scfg.k_max, qb.tids.device)
        return fn(qb.tids, qb.ws, d)

    def warmup(shapes) -> None:
        for q, nq in shapes:
            tids = torch.full((q, nq), vocab, dtype=torch.int32, device=device)
            fn(tids, torch.zeros((q, nq), dtype=torch.float32, device=device),
               dynamic_args(defaults, q, scfg.k_max, device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run.warmup = warmup
    run.n_traces = lambda: 0
    run.supports_dynamic = True
    run.static_cfg = scfg
    run.defaults = defaults
    run.vocab = vocab
    run.device = device
    return run


class SearchRunner:
    """The traversal closed over ``index`` behind the dynamic-runner contract
    (the counterpart of the JAX package's ``jit_search``): any batch shape and
    any per-row mix of ``DynamicParams`` through one callable, with
    ``warmup(shapes)``, ``n_traces()`` and ``graph_stats()``.

    On CUDA through the kernels (``core.graphs.graphs_engage``) each call
    replays CUDA graphs of the traversal's op chains, one set per (Q, nq
    bucket), captured on the shape's first call (``warmup`` captures ahead);
    ``n_traces()`` counts the sets, as JAX counts compiled traces. Elsewhere
    (the CPU, impl "ref" and "legacy") each call runs ``search_retrieve``
    eagerly and ``n_traces()`` stays 0."""

    supports_dynamic = True

    def __init__(self, index: LSPIndex, scfg: StaticConfig, impl: str = "auto",
                 defaults: Optional[DynamicParams] = None):
        self.static_cfg = scfg
        self.defaults = (defaults or DynamicParams(k=scfg.k_max)).validate_for(scfg)
        self.vocab = index.vocab
        self.device = index_device(index)
        ops.scoring_operand(index, scfg.doc_layout)

        def traverse(qb: QueryBatch, d: DynamicArgs) -> RetrievalResult:
            # holds no reference to the runner: a runner dropped frees its graphs at once,
            # not in a later collection that might fall inside another runner's capture
            return search_retrieve(index, qb, scfg, d, impl=impl)

        self._traverse = traverse
        self._graphs = None
        if graphs_engage(self.device, impl):
            constants = frozenset(t.untyped_storage().data_ptr() for t in _tensors(index))
            self._graphs = ShapeGraphs(traverse, self.vocab, self.device, constants)
        self._eager = 0
        self._eager_lock = threading.Lock()

    def __call__(self, qb: QueryBatch, dyn: Dynamic = None) -> RetrievalResult:
        validate_dynamic(dyn, self.static_cfg)
        dyn = self.defaults if dyn is None else dyn
        q = qb.tids.shape[0]
        if self._graphs is None:
            with self._eager_lock:
                self._eager += 1
            return self._traverse(qb, dynamic_args(dyn, q, self.static_cfg.k_max, qb.tids.device))
        rows = [dyn] * q if isinstance(dyn, DynamicParams) else list(dyn)
        if len(rows) != q:
            raise ValueError(f"per-row params: got {len(rows)} for a batch of {q} rows")
        return self._graphs(qb, rows)

    def warmup(self, shapes) -> None:
        """Run each (Q, nq) shape once on sentinel queries: on CUDA this
        builds and loads the kernels and captures the shape's graphs."""
        for q, nq in shapes:
            self(QueryBatch(torch.full((q, nq), self.vocab, dtype=torch.int32, device=self.device),
                            torch.zeros((q, nq), dtype=torch.float32, device=self.device), self.vocab))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def n_traces(self) -> int:
        return 0 if self._graphs is None else len(self._graphs.sets)

    def graph_stats(self) -> dict:
        """Calls that captured a graph set, calls that replayed one, and
        calls that ran the eager traversal."""
        g = self._graphs
        return {"captures": 0 if g is None else g.captures, "replays": 0 if g is None else g.replays,
                "eager": self._eager}


def make_search_runner(
    index: LSPIndex,
    scfg: StaticConfig,
    impl: str = "auto",
    defaults: Optional[DynamicParams] = None,
) -> SearchRunner:
    """The traversal closed over ``index`` behind the dynamic-runner contract
    (``SearchRunner``)."""
    return SearchRunner(index, scfg, impl, defaults)
