"""Collectives of the sharded paths over a ``torch.distributed`` process group.

The port of the JAX package's ``distributed/topk.py``. Where the JAX package
runs ``lax.all_gather(x, "model", axis=1, tiled=True)`` inside ``shard_map``,
the port all-gathers over a process group, one rank per shard, and
concatenates on axis 1 in rank order (``all_gather_cat``).

The other collectives of the port's mesh code live here too: the sum over a
group (``lax.psum``), its reduce-scatter and the all-gather on dim 0 (the
vocab-parallel lookup and the compressed gradient all-reduce), and the
maximum (``lax.pmax``). On a gloo group a CUDA tensor goes through host
memory explicitly (gloo moves host tensors; ``to_wire``); on an NCCL group
device tensors are exchanged where they are. NCCL takes one rank per card, so
ranks that share a card run over gloo.

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


def wire_device(t: torch.Tensor, group=None) -> torch.device:
    """Where ``t`` crosses ``group``: host memory for a CUDA tensor on a gloo
    group (gloo moves host tensors), else ``t``'s own device."""
    return torch.device("cpu") if t.is_cuda and dist.get_backend(group) == "gloo" else t.device


def to_wire(t: torch.Tensor, group, copy: bool = False) -> torch.Tensor:
    """``t`` detached and contiguous on its ``wire_device``; a copy when
    ``copy`` (for a collective that writes its input)."""
    return t.detach().to(wire_device(t, group), copy=copy).contiguous()


def all_gather_cat(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` [Q, n] concatenated on axis 1 in rank order
    -> [Q, world * n], on ``t``'s device: ``lax.all_gather(t, axis=1,
    tiled=True)`` over a process group. Every rank passes the same shape."""
    src = to_wire(t, group)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=1).to(t.device)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (``lax.psum``), a new tensor on ``t``'s
    device; ``t`` itself when the group is None (an axis of size 1)."""
    if group is None:
        return t
    out = to_wire(t, group, copy=True)
    dist.all_reduce(out, group=group)
    return out.to(t.device)


def reduce_scatter0(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, of which this rank keeps its slice of
    dim 0 (``lax.psum_scatter(t, scatter_dimension=0, tiled=True)``): the
    group's i-th rank keeps rows [i n/w, (i+1) n/w)."""
    if group is None:
        return t
    w = dist.get_world_size(group)
    if t.shape[0] % w:
        raise ValueError(f"dim 0 of size {t.shape[0]} does not split over a group of {w} ranks")
    src = to_wire(t, group)
    out = src.new_empty((t.shape[0] // w,) + tuple(t.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(t.device)


def all_gather0(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated on dim 0 in group order
    (``lax.all_gather(t, axis=0, tiled=True)``)."""
    if group is None:
        return t
    src = to_wire(t, group)
    out = src.new_empty((dist.get_world_size(group) * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(t.device)


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
    out = to_wire(x, group, copy=True)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out.to(x.device)
