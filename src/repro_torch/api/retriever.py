"""The ``Retriever`` facade.

    retr = Retriever.build(corpus)                       # index on the GPU + local backend
    resp = retr.search(SearchRequest(tids, ws))           # one query, typed
    resp = retr.search(SearchRequest(tids, ws, params=DynamicParams(k=5, beta=0.5)))
    resps = retr.search_batch([SearchRequest(...), ...])  # one batched call

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
                 defaults: DynamicParams, backend_name: str):
        self._backend = backend_callable
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
        index = index_to(index, resolve_device(device))
        if static_cfg is None:
            k = params.k if params is not None else DynamicParams.k
            static_cfg = recommended_static(k, n_superblocks=index.n_superblocks)
        defaults = (params or DynamicParams.recommended(static_cfg.k_max)).validate_for(static_cfg)
        run = get_backend(backend)(index, static_cfg, impl=impl, defaults=defaults, **backend_kw)
        return cls(run, index=index, static_cfg=static_cfg, defaults=defaults, backend_name=backend)

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
        index = build_index(doc_ptr, tids, ws, vocab, build_cfg or IndexBuildConfig(), device=device)
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
