"""Deterministic top-k selection.

Two orders matter to the traversal and both must match the JAX package's:

* ``stable_topk`` — ``jax.lax.top_k``'s: value descending, equal values by
  lower position. ``torch.topk`` gives no such promise (on the CPU,
  ``torch.topk([1, 2, 2, 2, .5], 2)`` returns indices [1, 3]; on CUDA the
  order is unspecified), so every site whose *indices* are consumed uses a
  stable descending sort instead.
* ``canonical_topk`` — (score descending, id ascending), the total order that
  makes the selection independent of traversal order. Written as an explicit
  two-key stable sort: sort by id, then stably by score.
"""

from __future__ import annotations

import torch


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties broken by lower position (lax.top_k's rule)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def canonical_topk(scores: torch.Tensor, ids: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k by (score desc, id asc) along the last axis -> (vals [..., k], ids [..., k]).
    Requires N >= k."""
    ids = ids.to(torch.int32)
    by_id = torch.argsort(ids, dim=-1, stable=True)
    s1 = scores.gather(-1, by_id)
    i1 = ids.gather(-1, by_id)
    by_score = torch.argsort(s1, dim=-1, descending=True, stable=True)[..., :k]
    return s1.gather(-1, by_score), i1.gather(-1, by_score)


def canonical_keep_mask(scores: torch.Tensor, ids: torch.Tensor, cut_vals: torch.Tensor,
                        cut_ids: torch.Tensor) -> torch.Tensor:
    """Membership against a canonical cutoff: True where (score, id) orders
    at or before (cut_val, cut_id) under (score desc, id asc).

    scores/ids [..., N]; cut_vals/cut_ids [...] (one cutoff pair per row).
    When the cutoff is the k-th entry of ``canonical_topk`` over a union of
    sets with globally unique ids, the order is total, so exactly the union's
    canonical top-k entries pass, on whichever part of the union each caller
    holds: a shard tells which of its blocks made the global cut without
    being sent the member list."""
    cv = cut_vals[..., None]
    ci = cut_ids[..., None]
    return (scores > cv) | ((scores == cv) & (ids <= ci))
