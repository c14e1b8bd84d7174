"""The port's Retriever facade against the JAX package's, on the same index:
equal ids, θ and visit counters through ``search`` and ``search_batch``."""

import numpy as np
import pytest
import torch

from repro.api import DynamicParams as JaxDynamicParams, Retriever as JaxRetriever
from repro.api import SearchRequest as JaxSearchRequest, StaticConfig as JaxStaticConfig
from repro_torch.api import DynamicParams, Retriever, SearchRequest, StaticConfig, list_backends
from repro_torch.index.builder import IndexBuildConfig
from repro_torch.index.convert import from_arrays

SCFG = dict(variant="lsp0", gamma=8, gamma0=2, k_max=10)


@pytest.fixture(scope="module")
def retrievers(tiny_index):
    jax_retr = JaxRetriever.from_index(tiny_index, JaxStaticConfig(**SCFG))
    port = Retriever.from_index(from_arrays(tiny_index, "cpu"), StaticConfig(**SCFG), device="cpu")
    return jax_retr, port


def _assert_responses_equal(got, want, queries):
    """Equal results; the port pads the batch to its longest query, where the
    JAX facade pads to a compiled-shape bucket."""
    assert len(got) == len(want)
    nq = max(len(t) for t, _ in queries)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        np.testing.assert_allclose(g.scores, w.scores, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.theta, w.theta, rtol=1e-5, atol=1e-5)
        assert (g.n_superblocks_visited, g.n_blocks_scored) == (w.n_superblocks_visited, w.n_blocks_scored)
        assert g.bucket == (len(got), nq) and g.bucket[0] == w.bucket[0] and g.k == w.k


def test_search_batch_matches_jax(tiny_corpus, retrievers):
    _, _, queries = tiny_corpus
    jax_retr, port = retrievers
    want = jax_retr.search_batch([JaxSearchRequest(t, w) for t, w in queries])
    got = port.search_batch([SearchRequest(t, w) for t, w in queries])
    _assert_responses_equal(got, want, queries)


def test_search_one_by_one_matches_jax(tiny_corpus, retrievers):
    _, _, queries = tiny_corpus
    jax_retr, port = retrievers
    for t, w in queries:
        _assert_responses_equal([port.search(SearchRequest(t, w))], [jax_retr.search(JaxSearchRequest(t, w))],
                                [(t, w)])


def test_per_request_params_match_jax(tiny_corpus, retrievers):
    _, _, queries = tiny_corpus
    jax_retr, port = retrievers
    points = [dict(k=3), dict(k=10, beta=1.0), dict(k=6, mu=0.2, eta=0.8)]
    want = jax_retr.search_batch(
        [JaxSearchRequest(t, w, JaxDynamicParams(**points[i % 3])) for i, (t, w) in enumerate(queries)])
    got = port.search_batch([SearchRequest(t, w, DynamicParams(**points[i % 3])) for i, (t, w) in enumerate(queries)])
    _assert_responses_equal(got, want, queries)
    assert [r.k for r in got] == [points[i % 3]["k"] for i in range(len(queries))]


def test_exact_backend_matches_jax(tiny_corpus, tiny_index):
    _, _, queries = tiny_corpus
    jax_ex = JaxRetriever.from_index(tiny_index, JaxStaticConfig(**SCFG), backend="exact")
    port_ex = Retriever.from_index(from_arrays(tiny_index, "cpu"), StaticConfig(**SCFG), backend="exact",
                                   device="cpu")
    want = jax_ex.search_batch([JaxSearchRequest(t, w) for t, w in queries])
    got = port_ex.search_batch([SearchRequest(t, w) for t, w in queries])
    _assert_responses_equal(got, want, queries)


def test_build_recommended_defaults_and_runner_contract(tiny_corpus):
    _, corpus, queries = tiny_corpus
    retr = Retriever.build(corpus, build_cfg=IndexBuildConfig(b=8, c=8, kmeans_iters=1), device="cpu")
    assert retr.static_cfg == StaticConfig(gamma=retr.index.n_superblocks, gamma0=32, k_max=10)
    assert retr.defaults == DynamicParams.recommended(10)
    retr.warmup([(2, 16)])
    resp = retr.search(SearchRequest(*queries[0]))
    assert resp.doc_ids.shape == (10,) and np.isfinite(resp.scores).all()
    assert retr.n_traces() == 0 and list_backends() == ["exact", "local", "shard_map", "sharded"]


def test_default_device_needs_a_card(tiny_index, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Retriever.from_index(from_arrays(tiny_index, "cpu"))
