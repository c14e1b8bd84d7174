"""Collectives of the sharded paths over a ``torch.distributed`` process group.

The port of the JAX package's ``distributed/topk.py``. Where the JAX package
runs ``lax.all_gather(x, "model", axis=1, tiled=True)`` inside ``shard_map``,
the port all-gathers over a process group, one rank per shard, and
concatenates on axis 1 in rank order (``all_gather_cat``).

On a gloo group a CUDA tensor goes through host memory explicitly (gloo
moves host tensors); on an NCCL group device tensors are gathered where they
are. NCCL takes one rank per card, so ranks that share a card run over gloo.

Selection is canonical (value desc, global id asc; ``core/topk.py``), so the
merge of per-rank canonical top-ks is exact: the canonical top-k of a union
equals the canonical top-k of the union of per-part canonical top-ks, and
with global positions as ids it equals ``stable_topk`` over the unsharded
row.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.scoring import NEG
from repro_torch.core.topk import canonical_topk


def _via_host(t: torch.Tensor, group) -> bool:
    """True when ``t`` must cross ``group`` through host memory: a CUDA tensor
    on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_cat(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` [Q, n] concatenated on axis 1 in rank order
    -> [Q, world * n], on ``t``'s device: ``lax.all_gather(t, axis=1,
    tiled=True)`` over a process group. Every rank passes the same shape."""
    host = _via_host(t, group)
    src = (t.cpu() if host else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=1)
    return out.to(t.device) if host else out


def merge_shard_results(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Canonical (score desc, id asc) merge of per-shard top-k lists
    concatenated to [Q, P*k] (NEG where a shard had no result): equal scores
    at the k boundary resolve by id, never by shard order. Returns (ids
    [Q, k], -1 where none; scores [Q, k])."""
    vals, out_ids = canonical_topk(scores, ids, k)
    return torch.where(vals > NEG / 2, out_ids, -1), vals


def distributed_topk(
    scores: torch.Tensor,  # [Q, N_local]
    k: int,
    group=None,
    local_offset: Optional[int] = None,
    ids: Optional[torch.Tensor] = None,  # [Q, N_local] global ids; default: global positions
) -> tuple[torch.Tensor, torch.Tensor]:
    """Canonical top-k across a row sharded over ``group``: local canonical
    top-k, all-gather of the (value, global id) pairs, canonical final top-k.
    Returns (vals [Q, k], global ids int32 [Q, k]) on every rank. Without
    ``ids`` the ids are positions offset by ``local_offset`` (default
    rank * N_local)."""
    n_local = scores.shape[-1]
    if ids is None:
        if local_offset is None:
            local_offset = dist.get_rank(group) * n_local
        ids = (torch.arange(n_local, dtype=torch.int32, device=scores.device) + local_offset).expand_as(scores)
    lv, li = canonical_topk(scores, ids, min(k, n_local))
    return canonical_topk(all_gather_cat(lv, group), all_gather_cat(li, group), k)


def pmax_scalar(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise maximum of ``x`` over the ranks of ``group`` (``lax.pmax``)."""
    host = _via_host(x, group)
    out = x.detach().cpu().clone() if host else x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out.to(x.device) if host else out
