"""Backend registry of the search facade.

A backend factory ``factory(index, static_cfg, *, impl, defaults, ...)``
returns a callable with the ``core.lsp.make_dynamic_runner`` contract:

    retriever(qb: QueryBatch, dyn=None) -> RetrievalResult
    retriever.supports_dynamic / .warmup(shapes) / .n_traces()
    retriever.static_cfg / .defaults / .vocab

Built-ins:
  local      the single-device LSP traversal (the default)
  sharded    the host-loop sharded transport: equal to ``local``, every shard
             on one device (``distributed.sharded.ShardedRetriever``)
  shard_map  the process-group transport, the counterpart of the JAX
             package's mesh backend: one ``torch.distributed`` rank per
             shard (``group=`` in place of ``mesh=``)
  exact      the rank-safe exhaustive oracle behind the same contract
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.config import DynamicParams, StaticConfig
from repro_torch.core.exact import retrieve_exact
from repro_torch.core.lsp import RetrievalResult, make_dynamic_runner, make_search_runner, mask_beyond_k
from repro_torch.core.query import QueryBatch
from repro_torch.index.layout import LSPIndex, index_device

_REGISTRY: dict[str, Callable] = {}


def register_backend(name: str):
    """Decorator: register ``factory(index, static_cfg, **kw) -> retriever``."""

    def deco(factory: Callable) -> Callable:
        _REGISTRY[name] = factory
        return factory

    return deco


def get_backend(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; registered backends: {sorted(_REGISTRY)}") from None


def list_backends() -> list[str]:
    return sorted(_REGISTRY)


def _require_index(index, name: str) -> None:
    if not isinstance(index, LSPIndex):
        raise ValueError(f"backend {name!r} serves one LSPIndex; a sharded index set needs backend "
                         f"'sharded' or 'shard_map'")


@register_backend("local")
def local_backend(index: LSPIndex, static_cfg: StaticConfig, *, impl: str = "auto",
                  defaults: Optional[DynamicParams] = None):
    """The single-device LSP traversal (the default)."""
    _require_index(index, "local")
    return make_search_runner(index, static_cfg, impl=impl, defaults=defaults)


@register_backend("sharded")
def sharded_backend(index, static_cfg: StaticConfig, *, shards: int = 0, impl: str = "auto",
                    defaults: Optional[DynamicParams] = None, ns_true: Optional[int] = None):
    """The host-loop sharded transport: equal to 'local', with index memory cut
    into contiguous superblock ranges. ``index`` is an ``LSPIndex`` (cut into
    ``shards``), a ``store.ShardedIndex`` or a list of shards."""
    from repro_torch.distributed.sharded import ShardedRetriever

    return ShardedRetriever(index, static_cfg, n_shards=shards or None, impl=impl, ns_true=ns_true,
                            defaults=defaults)


@register_backend("shard_map")
def shard_map_backend(index, static_cfg: StaticConfig, *, shards: int = 0, group=None, impl: str = "auto",
                      defaults: Optional[DynamicParams] = None, ns_true: Optional[int] = None):
    """The process-group transport (the JAX package's mesh backend): this
    rank serves its own shard of ``index`` over ``group``, a
    ``torch.distributed`` process group of one rank per shard, which takes
    the place of the JAX ``mesh=``. Every rank calls the retriever with the
    same batches."""
    from repro_torch.distributed.sharded import ShardedRetriever

    if group is None:
        raise ValueError("backend 'shard_map' needs group= (a torch.distributed process group, one rank a shard)")
    return ShardedRetriever(index, static_cfg, n_shards=shards or None, group=group, impl=impl,
                            ns_true=ns_true, defaults=defaults)


@register_backend("exact")
def exact_backend(index: LSPIndex, static_cfg: StaticConfig, *, impl: str = "auto",
                  defaults: Optional[DynamicParams] = None, doc_chunk: int = 8192):
    """Rank-safe exhaustive oracle behind the same dynamic contract. Dynamic k
    masks the top-k_max prefix; μ/η/β and ``impl`` have no effect (nothing is
    pruned, and exhaustive scoring has no kernel). θ and the visit counters
    report 0."""
    _require_index(index, "exact")
    scfg = static_cfg
    defaults = (defaults or DynamicParams(k=scfg.k_max)).validate_for(scfg)

    def fn(tids, ws, d):
        ids, vals = retrieve_exact(index, QueryBatch(tids, ws, index.vocab), scfg.k_max, doc_chunk)
        vals, ids = mask_beyond_k(vals, ids, d.k)
        zeros = torch.zeros(tids.shape[0], dtype=torch.int32, device=tids.device)
        return RetrievalResult(ids, vals, zeros, zeros, theta=zeros.to(torch.float32))

    return make_dynamic_runner(fn, scfg, defaults, index.vocab, index_device(index))
