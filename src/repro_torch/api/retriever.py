"""The ``Retriever`` facade.

    retr = Retriever.build(corpus)                       # index on the GPU + local backend
    resp = retr.search(SearchRequest(tids, ws))           # one query, typed
    resp = retr.search(SearchRequest(tids, ws, params=DynamicParams(k=5, beta=0.5)))
    resps = retr.search_batch([SearchRequest(...), ...])  # one batched call
    retr.save("/path/to/index")                           # the lsp-index directory format
    retr = Retriever.load("/path/to/index")               # ... written by either package
    retr = Retriever.load("/path/to/sharded")             # a shard set, at its stored shard count
    retr = Retriever.build(corpus, shards=4)              # cut into 4 shards, the sharded backend
    eng = retr.serve(max_batch=64, cache_size=1024)       # async bucketed engine
    retr.add([(tids, ws), ...]); retr.delete([doc_id])     # live mutation
    retr.compact()                                        # fold the delta into superblocks

The facade owns the static/dynamic boundary: ``StaticConfig`` sizes the
traversal (the backend registry: local, sharded, shard_map, exact), the paper's
``DynamicParams.recommended(k)`` preset is the default dynamic point, and any
request may override it. Everything runs on CUDA unless ``device="cpu"`` is
passed. ``mutable()`` (or the first ``add``/``delete``) promotes a retriever
to a live-mutable one: adds land in an exactly scored delta segment, deletes
become tombstones, ``compact()`` rebuilds the superblocks on the index's
device, and ``save``/``load`` keep the delta and tombstones (the JAX
package's ``lsp-mutable-index`` format).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.api.backends import get_backend
from repro_torch.api.types import SearchRequest, SearchResponse
from repro_torch.core.config import DynamicParams, StaticConfig, recommended_static
from repro_torch.core.query import make_query_batch
from repro_torch.device import resolve_device, to_host
from repro_torch.index.layout import LSPIndex, index_device, index_to


def _lead(index) -> LSPIndex:
    """The LSPIndex whose vocab and device stand for ``index``: itself, or the
    first shard held of a sharded set (a ``ShardedIndex`` or a list of
    shards; a process-group rank holds only its own)."""
    if isinstance(index, LSPIndex):
        return index
    return next(s for s in getattr(index, "shards", index) if s is not None)


def _to_device(index, device):
    """``index`` (an LSPIndex, a ``ShardedIndex`` or a list of shards) with
    every tensor on ``device``."""
    if isinstance(index, LSPIndex):
        return index_to(index, device)
    if hasattr(index, "shards"):
        return index._replace(shards=tuple(None if s is None else index_to(s, device) for s in index.shards))
    return [None if s is None else index_to(s, device) for s in index]


def _corpus_arrays(corpus):
    """Accept a ``data.synthetic.Corpus`` (or anything with the same attributes)
    or a bare (doc_ptr, tids, ws, vocab) tuple."""
    if hasattr(corpus, "doc_ptr"):
        return corpus.doc_ptr, corpus.tids, corpus.ws, corpus.vocab
    doc_ptr, tids, ws, vocab = corpus[:4]
    return doc_ptr, tids, ws, vocab


class Retriever:
    """Search facade over an index and a registered backend.

    Construction: ``build`` (corpus -> index), ``load`` (a persisted
    directory: single, sharded or mutable) or ``from_index`` (an
    ``LSPIndex``, a ``store.ShardedIndex`` or a list of shards). The backend
    resolves itself: 'local' for one index, 'sharded' when shards are asked
    for or given, 'shard_map' when a process ``group`` is given too; or pass
    ``backend=`` (``api.backends.list_backends()``). ``index`` is what was
    served (a ``MutableIndex`` once promoted). A retriever over a sharded set
    can neither be promoted nor saved in place; one built from a corpus with
    ``shards=`` keeps the unsharded index and promotes."""

    def __init__(self, backend_callable, *, index, static_cfg: StaticConfig,
                 defaults: DynamicParams, backend_name: str, factory=None):
        self._backend = backend_callable
        self._factory = factory
        self._build_cfg = None  # the IndexBuildConfig of build(), recorded by save()
        self._corpus = None  # (doc_ptr, tids, ws) kept by build() for promotion
        self._adapter = None  # serve.mutable.MutableRetrieverAdapter once promoted
        self.index = index
        self.static_cfg = static_cfg
        self.defaults = defaults
        self.backend_name = backend_name
        self.vocab = _lead(index).vocab
        self.device = index_device(_lead(index))

    @classmethod
    def from_index(
        cls,
        index,
        static_cfg: Optional[StaticConfig] = None,
        *,
        params: Optional[DynamicParams] = None,
        backend: Optional[str] = None,
        shards: int = 0,
        group=None,
        impl: str = "auto",
        ns_true: Optional[int] = None,
        device=None,
        **backend_kw,
    ) -> "Retriever":
        """Serve ``index`` (moved to ``device``, CUDA by default) through
        ``backend``. ``shards=P`` cuts an ``LSPIndex`` into P shards; a
        ``ShardedIndex`` or a list of shards is served at its own count
        (``ns_true``: the global superblock count of a padded shard list).
        ``group`` (a ``torch.distributed`` process group of one rank per
        shard) serves this rank's shard through the process-group
        transport."""
        device = resolve_device(device)
        index = _to_device(index, device)
        stored_shards = len(index.shards) if hasattr(index, "shards") else 0
        is_shard_list = not isinstance(index, LSPIndex) and not stored_shards
        is_sharded = bool(stored_shards or shards or is_shard_list)
        if backend is None:
            backend = "shard_map" if (group is not None and is_sharded) else ("sharded" if is_sharded else "local")
        if static_cfg is None:
            k = params.k if params is not None else DynamicParams.k
            # a bare shard list has no global count; the shards' sum (>= the
            # true count, by the tail padding) is a safe γ clamp
            ns = ns_true or (len(index) * _lead(index).n_superblocks if is_shard_list else index.n_superblocks)
            static_cfg = recommended_static(k, n_superblocks=ns)
        defaults = (params or DynamicParams.recommended(static_cfg.k_max)).validate_for(static_cfg)
        make = get_backend(backend)
        kw = dict(impl=impl, defaults=defaults, **backend_kw)
        if backend in ("sharded", "shard_map"):
            kw.update(shards=shards or stored_shards, ns_true=ns_true)
        if group is not None:
            kw["group"] = group

        def factory(ix):
            """The backend over a fresh index on this retriever's device, at the
            same static config, defaults, impl and shard count: the hot-swap
            hook of the serving engine's ``swap_index`` (a single index, or a
            ``ShardedIndex`` whose shards flip together)."""
            return make(_to_device(ix, device), static_cfg, **kw)

        return cls(factory(index), index=index, static_cfg=static_cfg, defaults=defaults, backend_name=backend,
                   factory=factory)

    @classmethod
    def build(
        cls,
        corpus,
        static_cfg: Optional[StaticConfig] = None,
        *,
        build_cfg=None,
        params: Optional[DynamicParams] = None,
        backend: Optional[str] = None,
        shards: int = 0,
        group=None,
        impl: str = "auto",
        device=None,
        **backend_kw,
    ) -> "Retriever":
        """Build an index over ``corpus`` on ``device`` (CUDA by default) and
        serve it (cut into ``shards`` with the sharded backend when asked)."""
        from repro_torch.index.builder import IndexBuildConfig, build_index

        device = resolve_device(device)
        doc_ptr, tids, ws, vocab = _corpus_arrays(corpus)
        build_cfg = build_cfg or IndexBuildConfig()
        index = build_index(doc_ptr, tids, ws, vocab, build_cfg, device=device)
        retr = cls.from_index(index, static_cfg, params=params, backend=backend, shards=shards, group=group,
                              impl=impl, device=device, **backend_kw)
        # the source corpus: mutable() then starts from the exact floats, not
        # from the dequantized forward index
        retr._corpus = (np.asarray(doc_ptr), np.asarray(tids), np.asarray(ws))
        retr._build_cfg = build_cfg
        return retr

    @classmethod
    def load(
        cls,
        directory: str,
        static_cfg: Optional[StaticConfig] = None,
        *,
        params: Optional[DynamicParams] = None,
        backend: Optional[str] = None,
        shards: Optional[int] = None,
        group=None,
        impl: str = "auto",
        mmap: bool = True,
        device=None,
        **backend_kw,
    ) -> "Retriever":
        """Open a persisted directory (``index.store``; one written by the JAX
        package too) onto ``device`` (CUDA by default) and serve it. A sharded
        directory is served by the sharded backend at its stored shard count
        (with ``group``, each rank loads only its own shard); ``shards=``
        re-shards a single-index directory in memory. A mutable directory
        (``save_mutable_index``) comes back promoted, with its delta segment,
        tombstones and id counters, so ``add``/``delete``/``compact`` resume
        where the save left off."""
        from repro_torch.index.store import (
            MUTABLE_MANIFEST_FORMAT,
            SHARDED_MANIFEST_FORMAT,
            load_index,
            load_index_auto,
            load_mutable_index,
            load_shard_of,
            manifest_format,
            read_sharded_manifest,
        )

        device = resolve_device(device)
        fmt = manifest_format(directory)
        if fmt == SHARDED_MANIFEST_FORMAT:
            stored = read_sharded_manifest(directory)["n_shards"]
            if shards and shards != stored:
                raise ValueError(
                    f"{directory} stores a {stored}-shard index; cannot serve it as "
                    f"shards={shards} — re-save with save_sharded_index or drop shards="
                )
            if group is None:
                index = load_index_auto(directory, mmap=mmap, device=device)
            else:
                import torch.distributed as dist

                index = load_shard_of(directory, dist.get_rank(group), mmap=mmap, device=device)
            return cls.from_index(index, static_cfg, params=params, backend=backend, group=group, impl=impl,
                                  device=device, **backend_kw)
        if fmt != MUTABLE_MANIFEST_FORMAT:
            index = load_index(directory, mmap=mmap, device=device)
            return cls.from_index(index, static_cfg, params=params, backend=backend, shards=shards or 0,
                                  group=group, impl=impl, device=device, **backend_kw)
        if shards or group is not None:
            raise ValueError(
                f"{directory} is a mutable-index save; it serves single-device "
                f"(delta merge is host-side) — drop shards=/group=, or compact "
                f"and re-save with save_sharded_index for sharded serving"
            )
        from repro_torch.serve.mutable import MutableRetrieverAdapter

        mi = load_mutable_index(directory, mmap=mmap, device=device)
        retr = cls.from_index(mi.state().main, static_cfg, params=params, backend=backend or "local", impl=impl,
                              device=device, **backend_kw)
        retr._build_cfg = mi.build_cfg
        mi.set_runtime(retr._backend)
        retr._adapter = MutableRetrieverAdapter(mi, retr._factory)
        retr._backend = retr._adapter
        retr.index = mi
        return retr

    def search(self, request: Union[SearchRequest, tuple]) -> SearchResponse:
        """One query; ``request.params`` overrides the default dynamic point."""
        if not isinstance(request, SearchRequest):
            request = SearchRequest(*request)
        return self.search_batch([request])[0]

    def search_batch(self, requests: Sequence[SearchRequest]) -> List[SearchResponse]:
        """One batched call through the backend; per-request ``DynamicParams``
        mix freely within the batch (they ride as per-row tensors)."""
        requests = [r if isinstance(r, SearchRequest) else SearchRequest(*r) for r in requests]
        row_params = [(r.params or self.defaults).validate_for(self.static_cfg) for r in requests]
        # the batch's longest query: nothing is compiled per shape, so padding
        # the width further would only add dead term slots to every op
        nq = max([1] + [len(r.tids) for r in requests])
        qb = make_query_batch([(r.tids, r.weights) for r in requests], self.vocab, nq_max=nq,
                              device=self.device)
        out = self._backend(qb, row_params)
        ids = to_host(out.doc_ids)
        scores = to_host(out.scores)
        theta = None if out.theta is None else to_host(out.theta)
        nsb = to_host(out.n_superblocks_visited)
        nblk = to_host(out.n_blocks_scored)
        shard_cand = getattr(out, "shard_candidates", None)
        shard_cand = None if shard_cand is None else to_host(shard_cand)
        served_seq = int(getattr(out, "delta_seq", 0) or 0)
        return [
            SearchResponse(
                doc_ids=ids[i, : row_params[i].k].copy(),
                scores=scores[i, : row_params[i].k].copy(),
                theta=None if theta is None else float(theta[i]),
                n_superblocks_visited=int(nsb[i]),
                n_blocks_scored=int(nblk[i]),
                params=row_params[i],
                bucket=(len(requests), nq),
                shard_candidates=None if shard_cand is None else shard_cand[i].copy(),
                delta_seq=served_seq,
            )
            for i in range(len(requests))
        ]

    # ---- live mutation ---------------------------------------------------------

    def mutable(self) -> "Retriever":
        """Promote this retriever to a live-mutable one (idempotent, in place).

        The backend is wrapped in a ``serve.mutable.MutableRetrieverAdapter``
        over a ``MutableIndex``: adds land in an exactly scored delta segment,
        deletes become tombstones, and ``compact()`` folds both back into
        superblocks on this retriever's device. ``build()`` keeps the source
        corpus, so promotion is exact; a retriever over a loaded index
        reconstructs its corpus from the forward index (dequantized, see
        ``index.mutable.corpus_from_index``). A loaded sharded set cannot be
        promoted in place: its source corpus is not recoverable shard by shard.
        ``Retriever.build(corpus, shards=P)`` keeps the unsharded index and its
        corpus, so it promotes, and serves the main generation through the
        sharded backend."""
        if self._adapter is not None:
            return self
        from repro_torch.index.builder import IndexBuildConfig
        from repro_torch.index.mutable import MutableIndex, corpus_from_index
        from repro_torch.serve.mutable import MutableRetrieverAdapter

        main = self.index if isinstance(self.index, LSPIndex) else None
        if self._corpus is not None:
            doc_ptr, tids, ws = self._corpus
        elif main is not None:
            doc_ptr, tids, ws = corpus_from_index(main)
        else:
            from repro_torch.index.store import ShardedPromotionError

            raise ShardedPromotionError(
                "mutable() promotion of a sharded retriever",
                "the source corpus is not recoverable shard-wise; Retriever.load "
                "the single-index directory (the unsharded save) or "
                "Retriever.build from the corpus, promote THAT, and serve it "
                "with backend='sharded'",
            )
        mi = MutableIndex(main, doc_ptr, tids, ws, self.vocab, self._build_cfg or IndexBuildConfig(),
                          runtime=self._backend, device=self.device)
        self._adapter = MutableRetrieverAdapter(mi, self._factory)
        self._backend = self._adapter
        self.index = mi
        return self

    def add(self, docs) -> list[int]:
        """Add docs (each a ``(tids, weights)`` pair) to the live corpus; returns
        their external ids. Promotes on first use. New docs are visible to every
        later search (scored exactly from the delta segment until the next
        compaction)."""
        self.mutable()
        ids, _ = self._adapter.add_docs(docs)
        return ids

    def delete(self, ids) -> None:
        """Tombstone external doc ids: they never appear in results again.
        Raises KeyError on unknown or already-deleted ids."""
        self.mutable()
        self._adapter.delete_docs(ids)

    def compact(self) -> None:
        """Fold main + delta - tombstones into a fresh superblock generation,
        synchronously (a serving engine attaches a background
        ``CompactionManager`` instead; see ``serve()``)."""
        self.mutable()
        self._adapter.compact()

    def save(self, directory: str) -> str:
        """Persist the current state to ``directory`` (atomic commit). A promoted
        retriever writes the ``lsp-mutable-index`` format (main generation plus
        the delta and tombstones, so ``Retriever.load`` resumes mutation where
        this save left off); an unpromoted one writes ``lsp-index``. The JAX
        package reads both. Returns the content fingerprint."""
        from repro_torch.index.store import ShardedPromotionError, save_index, save_mutable_index

        if self._adapter is not None:
            return save_mutable_index(directory, self.index, self._build_cfg)
        if not isinstance(self.index, LSPIndex):
            raise ShardedPromotionError(
                "Retriever.save of a sharded retriever",
                "persist the shard set with "
                "repro_torch.index.store.save_sharded_index(directory, index, n_shards) "
                "from the original single LSPIndex, or save() a retriever loaded "
                "from the unsharded directory",
            )
        return save_index(directory, self.index, self._build_cfg)

    # ---- serving ---------------------------------------------------------------

    def serve(self, *, compaction=None, **engine_knobs):
        """Wrap this retriever in the async bucketed serving engine
        (``serve.RetrievalEngine``): batching, shape buckets, the result cache
        (keyed on the dynamic-params bytes), failure isolation and
        ``swap_index`` hot-swaps compose.

        A promoted retriever gets a background ``CompactionManager``
        (thresholds via ``compaction=dict(max_delta_docs=..., max_tombstones=...,
        interval_s=...)``; ``compaction=False`` serves without one), and the
        engine takes ``add_docs``/``delete_docs``."""
        from repro_torch.serve.engine import RetrievalEngine

        engine = RetrievalEngine(self._backend, self.vocab, default_params=self.defaults,
                                 retriever_factory=self._factory, **engine_knobs)
        if self._adapter is not None and compaction is not False:
            from repro_torch.serve.mutable import CompactionManager

            CompactionManager(engine, self._adapter, **(compaction or {}))
        return engine

    def n_traces(self) -> int:
        """Compiled-trace count of the backend: always 0 in the eager port."""
        return self._backend.n_traces()

    def warmup(self, shapes) -> None:
        self._backend.warmup(shapes)

    def __repr__(self) -> str:
        return (
            f"Retriever(backend={self.backend_name!r}, static={self.static_cfg}, "
            f"defaults={self.defaults}, device={self.device})"
        )
