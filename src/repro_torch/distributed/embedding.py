"""Vocab-parallel embedding lookup (Megatron-style) over a device mesh.

The port of the JAX package's ``distributed/embedding.py``, whose functions
run under ``shard_map``: each rank of a ``launch.mesh.DeviceMesh`` calls with
its row shard of the stacked table ``[R / n_model, D]`` (its ``model``
coordinate's rows, ``P("model", None)``) and its batch shard of global row
ids (``P(batch_axes, None)``):

  each rank gathers the ids it owns (others contribute zeros) -> one all-reduce
  over `model` gives the full [B_local, F, D] activation, replicated over `model`.

Ids outside the table give zero rows (no rank owns them), unlike
``models/recsys.py::field_lookup``, which wraps and clamps as JAX's gather
does.

Differentiable, with JAX's transposes: the all-reduce's is the identity (every
model rank already holds the whole cotangent of the replicated output), the
reduce-scatter's an all-gather, the masked gather's a masked scatter-add into
the owning shard; and the table, replicated over the batch axes, gets its
cotangent summed over them. So each rank's table gradient is its slice of the
whole table's gradient over the global batch, as JAX's ``jax.grad`` gives.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.topk import all_gather0, all_reduce_sum, reduce_scatter0


class _VocabParallelLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_l, ids, lo, model_group, batch_group, scattered):
        r_local = table_l.shape[0]
        rel = ids.long() - lo
        own = (rel >= 0) & (rel < r_local)
        rows = table_l[rel.clamp(0, r_local - 1)]
        rows = torch.where(own[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
        out = reduce_scatter0(rows, model_group) if scattered else all_reduce_sum(rows, model_group)
        ctx.save_for_backward(rel, own)
        ctx.table = (table_l.shape, table_l.dtype, table_l.device)
        ctx.groups, ctx.scattered = (model_group, batch_group), scattered
        return out

    @staticmethod
    def backward(ctx, g):
        rel, own = ctx.saved_tensors
        shape, dtype, device = ctx.table
        model_group, batch_group = ctx.groups
        if ctx.scattered:
            g = all_gather0(g.contiguous(), model_group)
        grad = torch.zeros(shape, dtype=dtype, device=device)
        grad.index_add_(0, rel[own], g[own].to(dtype))
        return all_reduce_sum(grad, batch_group), None, None, None, None, None


def _lookup(table, flat_ids, mesh, batch_axes, scattered: bool) -> torch.Tensor:
    model_group = mesh.group("model")
    batch_group = mesh.group(tuple(batch_axes))
    lo = mesh.index("model") * table.shape[0]
    return _VocabParallelLookup.apply(table, flat_ids, lo, model_group, batch_group, scattered)


def vocab_parallel_lookup(table: torch.Tensor, flat_ids: torch.Tensor, mesh, batch_axes) -> torch.Tensor:
    """table: this rank's rows of the stacked table [R / n_model, D]; flat_ids
    int [B_local, F]: this rank's batch shard of global row ids -> [B_local,
    F, D], the same on every rank of the model axis."""
    return _lookup(table, flat_ids, mesh, batch_axes, scattered=False)


def vocab_parallel_lookup_scattered(table: torch.Tensor, flat_ids: torch.Tensor, mesh, batch_axes) -> torch.Tensor:
    """The reduce-scatter variant of ``vocab_parallel_lookup``: the partial rows
    are reduce-scattered along the BATCH dim instead of all-reduced, so each
    model rank gets its ``1 / n_model`` of the batch shard's rows (half the
    exchange of an all-reduce) and the dense layers after it run on a batch
    sharded over (batch_axes..., model).

    Requires B_local divisible by the model axis. Output: rows [m B_local /
    n_model, (m + 1) B_local / n_model) of the batch shard on model rank m;
    the global layout is P((*batch_axes, 'model'), None, None).
    """
    return _lookup(table, flat_ids, mesh, batch_axes, scattered=True)
