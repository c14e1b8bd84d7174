"""The ``Retriever`` facade.

    retr = Retriever.build(corpus)                       # index on the GPU + local backend
    resp = retr.search(SearchRequest(tids, ws))           # one query, typed
    resp = retr.search(SearchRequest(tids, ws, params=DynamicParams(k=5, beta=0.5)))
    resps = retr.search_batch([SearchRequest(...), ...])  # one batched call
    retr.save("/path/to/index")                           # the lsp-index directory format
    retr = Retriever.load("/path/to/index")               # ... written by either package
    eng = retr.serve(max_batch=64, cache_size=1024)       # async bucketed engine

The facade owns the static/dynamic boundary: ``StaticConfig`` sizes the
traversal (the backend registry picks local or exact), the paper's
``DynamicParams.recommended(k)`` preset is the default dynamic point, and any
request may override it. Everything runs on CUDA unless ``device="cpu"`` is
passed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

from repro_torch.api.backends import get_backend
from repro_torch.api.types import SearchRequest, SearchResponse
from repro_torch.core.config import DynamicParams, StaticConfig, recommended_static
from repro_torch.core.query import make_query_batch
from repro_torch.device import resolve_device
from repro_torch.index.layout import LSPIndex, index_device, index_to


def _corpus_arrays(corpus):
    """Accept a ``data.synthetic.Corpus`` (or anything with the same attributes)
    or a bare (doc_ptr, tids, ws, vocab) tuple."""
    if hasattr(corpus, "doc_ptr"):
        return corpus.doc_ptr, corpus.tids, corpus.ws, corpus.vocab
    doc_ptr, tids, ws, vocab = corpus[:4]
    return doc_ptr, tids, ws, vocab


class Retriever:
    """Search facade over one ``LSPIndex`` and a registered backend."""

    def __init__(self, backend_callable, *, index: LSPIndex, static_cfg: StaticConfig,
                 defaults: DynamicParams, backend_name: str, factory=None):
        self._backend = backend_callable
        self._factory = factory
        self._build_cfg = None  # the IndexBuildConfig of build(), recorded by save()
        self.index = index
        self.static_cfg = static_cfg
        self.defaults = defaults
        self.backend_name = backend_name
        self.vocab = index.vocab
        self.device = index_device(index)

    @classmethod
    def from_index(
        cls,
        index: LSPIndex,
        static_cfg: Optional[StaticConfig] = None,
        *,
        params: Optional[DynamicParams] = None,
        backend: str = "local",
        impl: str = "auto",
        device=None,
        **backend_kw,
    ) -> "Retriever":
        """Serve ``index`` (moved to ``device``, CUDA by default) through ``backend``."""
        device = resolve_device(device)
        index = index_to(index, device)
        if static_cfg is None:
            k = params.k if params is not None else DynamicParams.k
            static_cfg = recommended_static(k, n_superblocks=index.n_superblocks)
        defaults = (params or DynamicParams.recommended(static_cfg.k_max)).validate_for(static_cfg)
        make = get_backend(backend)

        def factory(ix):
            """The backend over a fresh index on this retriever's device, at the
            same static config, defaults and impl: the hot-swap hook of the
            serving engine's ``swap_index``."""
            return make(index_to(ix, device), static_cfg, impl=impl, defaults=defaults, **backend_kw)

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
        backend: str = "local",
        impl: str = "auto",
        device=None,
        **backend_kw,
    ) -> "Retriever":
        """Build an index over ``corpus`` on ``device`` (CUDA by default) and serve it."""
        from repro_torch.index.builder import IndexBuildConfig, build_index

        device = resolve_device(device)
        doc_ptr, tids, ws, vocab = _corpus_arrays(corpus)
        build_cfg = build_cfg or IndexBuildConfig()
        index = build_index(doc_ptr, tids, ws, vocab, build_cfg, device=device)
        retr = cls.from_index(index, static_cfg, params=params, backend=backend, impl=impl,
                              device=device, **backend_kw)
        retr._build_cfg = build_cfg
        return retr

    @classmethod
    def load(
        cls,
        directory: str,
        static_cfg: Optional[StaticConfig] = None,
        *,
        params: Optional[DynamicParams] = None,
        backend: str = "local",
        impl: str = "auto",
        mmap: bool = True,
        device=None,
        **backend_kw,
    ) -> "Retriever":
        """Open a persisted single-index directory (``index.store``; one written
        by the JAX package's ``save_index`` too) onto ``device`` (CUDA by
        default) and serve it through ``backend``."""
        from repro_torch.index.store import load_index

        device = resolve_device(device)
        index = load_index(directory, mmap=mmap, device=device)
        return cls.from_index(index, static_cfg, params=params, backend=backend, impl=impl,
                              device=device, **backend_kw)

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
        ids = out.doc_ids.cpu().numpy()
        scores = out.scores.cpu().numpy()
        theta = None if out.theta is None else out.theta.cpu().numpy()
        nsb = out.n_superblocks_visited.cpu().numpy()
        nblk = out.n_blocks_scored.cpu().numpy()
        return [
            SearchResponse(
                doc_ids=ids[i, : row_params[i].k].copy(),
                scores=scores[i, : row_params[i].k].copy(),
                theta=None if theta is None else float(theta[i]),
                n_superblocks_visited=int(nsb[i]),
                n_blocks_scored=int(nblk[i]),
                params=row_params[i],
                bucket=(len(requests), nq),
            )
            for i in range(len(requests))
        ]

    def save(self, directory: str) -> str:
        """Persist the index to ``directory`` (atomic commit) in the
        ``lsp-index`` format, which the JAX package's ``load_index`` reads too.
        Returns the content fingerprint."""
        from repro_torch.index.store import save_index

        return save_index(directory, self.index, self._build_cfg)

    def serve(self, **engine_knobs):
        """Wrap this retriever in the async bucketed serving engine
        (``serve.RetrievalEngine``): batching, shape buckets, the result cache
        (keyed on the dynamic-params bytes), failure isolation and
        ``swap_index`` hot-swaps compose."""
        from repro_torch.serve.engine import RetrievalEngine

        return RetrievalEngine(self._backend, self.vocab, default_params=self.defaults,
                               retriever_factory=self._factory, **engine_knobs)

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
