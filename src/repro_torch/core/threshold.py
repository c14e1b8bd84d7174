"""Initial top-k threshold estimation (paper ref. [39]).

The batched pipeline's round 0 (score top-γ₀ superblocks) already provides an
*underestimate-safe* θ. This module adds the cheaper sampling estimator for callers
that want to shrink γ₀: score a uniform sample of documents and take an order-statistic
corrected k-quantile. Underestimation is the safe direction (prunes less); we shrink
the estimate by `safety` to stay on that side.

``k`` is a host int (the static point) or an int32 tensor [Q] with ``k ≤ k_max``
(a per-row order statistic over a top-k of static width).

The JAX package draws its sample with ``jax.random.choice`` (threefry), which
the port cannot reproduce, so the estimator is split in two: ``sample_positions``
draws the sample from a ``torch.Generator`` and ``theta_at_positions`` scores it
and takes the order statistic, the JAX package's arithmetic on given positions.
"""

from __future__ import annotations

import torch

from repro_torch.core.query import QueryBatch, scatter_dense
from repro_torch.core.scoring import score_positions_fwd
from repro_torch.index.layout import LSPIndex


def _k_eff(k, n_sample: int, n_docs: int):
    """E[k-th of corpus] ~ (k * n_sample / n_docs)-th of a uniform sample."""
    scale = n_sample / max(n_docs, 1)
    if isinstance(k, torch.Tensor):
        return torch.clamp(torch.round(k * scale).to(torch.int32), 1, n_sample)
    return max(1, min(int(round(k * scale)), n_sample))


def sample_positions(n_pad: int, n_sample: int, seed: int = 0, device=None) -> torch.Tensor:
    """``min(n_sample, n_pad)`` distinct block-ordered positions in [0, n_pad),
    uniform without replacement, deterministic in ``seed`` on every device."""
    g = torch.Generator().manual_seed(seed)
    return torch.randperm(n_pad, generator=g)[: min(n_sample, n_pad)].to(device)


def theta_at_positions(index: LSPIndex, qb: QueryBatch, k, pos: torch.Tensor, safety: float = 0.9,
                       k_max: int = 0) -> torch.Tensor:
    """[Q] estimated k-th best score from the documents at ``pos`` [n_sample],
    scaled by ``safety``. With a tensor ``k``, pass ``k_max`` (the widest k the
    caller serves) so the top-k width is fixed."""
    n_sample = pos.shape[0]
    qdense = scatter_dense(qb)
    scores = score_positions_fwd(index, qdense, pos.expand(qb.tids.shape[0], n_sample))
    if not isinstance(k, torch.Tensor):
        vals = torch.topk(scores, _k_eff(k, n_sample, index.n_docs), dim=-1).values
        return torch.clamp_min(vals[:, -1] * safety, 0.0)
    # dynamic k: static width from k_max, per-row order statistic via masked min
    width = _k_eff(int(k_max) or n_sample, n_sample, index.n_docs)
    vals = torch.topk(scores, width, dim=-1).values
    sel = torch.arange(width, device=vals.device)[None, :] < torch.clamp_max(_k_eff(k, n_sample, index.n_docs),
                                                                             width)[:, None]
    kth = torch.where(sel, vals, torch.inf).amin(dim=-1)
    return torch.clamp_min(kth * safety, 0.0)


def estimate_theta(index: LSPIndex, qb: QueryBatch, k, n_sample: int = 1024, safety: float = 0.9, seed: int = 0,
                   k_max: int = 0) -> torch.Tensor:
    """[Q] estimated k-th best score over a uniform sample of ``n_sample``
    positions, scaled by ``safety``."""
    pos = sample_positions(index.doc_remap.shape[0], n_sample, seed, index.doc_remap.device)
    return theta_at_positions(index, qb, k, pos, safety, k_max)
