import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skipped where there is none")
    config.addinivalue_line("markers", "slow: a long test; informational, nothing deselects it")


@pytest.fixture(scope="session")
def tiny_corpus():
    from repro.data.synthetic import CorpusConfig, make_corpus, make_queries

    cfg = CorpusConfig(n_docs=2048, vocab=512, n_topics=8, seed=0)
    corpus = make_corpus(cfg)
    queries = make_queries(cfg, corpus, 16)
    return cfg, corpus, queries


@pytest.fixture(scope="session")
def tiny_index(tiny_corpus):
    from repro.index.builder import IndexBuildConfig, build_index

    _, corpus, _ = tiny_corpus
    return build_index(
        corpus.doc_ptr, corpus.tids, corpus.ws, corpus.vocab,
        IndexBuildConfig(b=8, c=8, kmeans_iters=3),
    )


@pytest.fixture(scope="session")
def tiny_qb(tiny_corpus):
    from repro.core import make_query_batch

    _, corpus, queries = tiny_corpus
    return make_query_batch(queries, corpus.vocab)


@pytest.fixture(scope="session")
def oracle(tiny_index, tiny_qb):
    from repro.core import retrieve_exact

    ids, vals = retrieve_exact(tiny_index, tiny_qb, k=10)
    return np.asarray(ids), np.asarray(vals)
