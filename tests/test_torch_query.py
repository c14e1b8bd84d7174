"""Query term ids outside [0, vocab], and ties, against the JAX package.

``scatter_dense`` must compute what ``jnp``'s ``.at[].add`` computes: an id in
[-(vocab+1), -1] wraps once, any other id outside [0, vocab] adds nothing, and
the sentinel column is zeroed. A whole search with such ids must then give
JAX's ids, θ and both visit counters (scores and θ within rtol=1e-5,
atol=1e-5: float32 sums in another order), for every variant, both document
layouts and the exact backend. The last test runs the traversal on a corpus
whose documents are tripled, so every score ties three ways.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import jit_search as jax_jit_search
from repro.core.config import StaticConfig as JaxStaticConfig
from repro.core.exact import retrieve_exact as jax_retrieve_exact
from repro.core.query import QueryBatch as JaxQueryBatch
from repro.core.query import make_query_batch as jax_make_query_batch
from repro.core.query import scatter_dense as jax_scatter_dense
from repro.data.synthetic import CorpusConfig, make_corpus, make_queries
from repro.index.builder import IndexBuildConfig, build_index
from repro_torch.core.config import StaticConfig
from repro_torch.core.exact import retrieve_exact
from repro_torch.core.lsp import search_retrieve
from repro_torch.core.query import QueryBatch, scatter_dense
from repro_torch.index.convert import from_arrays

TOL = dict(rtol=1e-5, atol=1e-5)
VARIANTS = {
    "lsp0": dict(variant="lsp0", gamma=8, gamma0=2),
    "lsp1": dict(variant="lsp1", gamma=8, gamma0=4),
    "lsp2": dict(variant="lsp2", gamma=8, gamma0=4),
    "sp": dict(variant="sp", gamma=16, gamma0=4),
    "bmp": dict(variant="bmp", gamma=16, gamma0=4),
}


def _both_scatters(tids, ws, vocab):
    want = np.asarray(jax_scatter_dense(JaxQueryBatch(jnp.asarray(tids), jnp.asarray(ws), vocab)))
    got = scatter_dense(QueryBatch(torch.from_numpy(tids), torch.from_numpy(ws), vocab)).numpy()
    return got, want


def test_scatter_dense_drops_and_wraps_like_jax():
    tids = np.array([[1, -1, 7, 9, -12]], np.int32)
    ws = np.array([[1.0, 2.0, 3.0, 4.0, 5.0]], np.float32)
    got, want = _both_scatters(tids, ws, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0]])


@pytest.mark.parametrize("vocab,seed", [(6, 0), (37, 1), (512, 2)])
def test_scatter_dense_matches_jax_on_every_id_in_twice_the_vocab(vocab, seed):
    """Every id in [-2·vocab, 2·vocab] appears, in seeded rows with duplicates."""
    rng = np.random.default_rng(seed)
    ids = np.arange(-2 * vocab, 2 * vocab + 1, dtype=np.int32)
    width = 16
    n_rows = -(-len(ids) // width) + 8
    tids = rng.choice(ids, (n_rows, width)).astype(np.int32)
    tids.reshape(-1)[: len(ids)] = rng.permutation(ids)
    ws = rng.random((n_rows, width)).astype(np.float32)
    got, want = _both_scatters(tids, ws, vocab)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)  # duplicates add in another order
    assert not got[:, vocab].any()


@pytest.fixture(scope="module")
def bad_batches(tiny_corpus):
    """The tiny queries with ids vocab + 3, -1 and -(vocab + 5) appended, as
    one JAX and one port QueryBatch."""
    _, corpus, queries = tiny_corpus
    vocab = corpus.vocab
    extra_t = np.array([vocab + 3, -1, -(vocab + 5)], np.int32)
    bad = [(np.concatenate([t, extra_t]), np.concatenate([w, np.array([0.6, 1.3, 2.0], np.float32)]))
           for t, w in queries]
    jqb = jax_make_query_batch(bad, vocab)
    pqb = QueryBatch(torch.from_numpy(np.array(jqb.tids)), torch.from_numpy(np.array(jqb.ws)), vocab)
    assert (np.asarray(jqb.tids) < 0).any() and (np.asarray(jqb.tids) > vocab).any()
    return jqb, pqb


def _assert_same(got, want):
    np.testing.assert_array_equal(got.doc_ids.numpy(), np.asarray(want.doc_ids))
    np.testing.assert_array_equal(got.n_superblocks_visited.numpy(), np.asarray(want.n_superblocks_visited))
    np.testing.assert_array_equal(got.n_blocks_scored.numpy(), np.asarray(want.n_blocks_scored))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), **TOL)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta), **TOL)


@pytest.mark.parametrize("layout", ["fwd", "flat"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_search_with_out_of_range_ids_matches_jax(tiny_index, bad_batches, variant, layout):
    jqb, pqb = bad_batches
    kw = dict(VARIANTS[variant], doc_layout=layout)
    want = jax_jit_search(tiny_index, JaxStaticConfig(**kw), impl="ref")(jqb)
    got = search_retrieve(from_arrays(tiny_index, "cpu"), pqb, StaticConfig(**kw))
    _assert_same(got, want)
    assert (np.asarray(want.doc_ids) >= 0).any()


def test_exact_with_out_of_range_ids_matches_jax(tiny_index, bad_batches):
    jqb, pqb = bad_batches
    want_ids, want_vals = jax_retrieve_exact(tiny_index, jqb, 10, doc_chunk=512)
    ids, vals = retrieve_exact(from_arrays(tiny_index, "cpu"), pqb, 10, doc_chunk=700)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_vals), **TOL)


@pytest.fixture(scope="module")
def tripled():
    """A 1,024-document corpus with every document tripled (3,072 documents,
    each score tied three ways), its JAX index and 24 queries."""
    cfg = CorpusConfig(n_docs=1024, vocab=512, n_topics=8, seed=3)
    c = make_corpus(cfg)
    lengths = np.diff(c.doc_ptr)
    order = np.repeat(np.arange(cfg.n_docs), 3)
    doc_ptr = np.concatenate([[0], np.cumsum(lengths[order])]).astype(c.doc_ptr.dtype)
    rows = [np.arange(c.doc_ptr[d], c.doc_ptr[d + 1]) for d in order]
    idx = build_index(doc_ptr, c.tids[np.concatenate(rows)], c.ws[np.concatenate(rows)], cfg.vocab,
                      IndexBuildConfig(b=8, c=8, kmeans_iters=2))
    qb = jax_make_query_batch(make_queries(cfg, c, 24, seed=5), cfg.vocab)
    return idx, qb


@pytest.mark.parametrize("case", list(VARIANTS) + ["lsp0_block_budget"])
def test_tie_heavy_traversal_matches_jax(tripled, case):
    idx, jqb = tripled
    kw = VARIANTS.get(case) or dict(VARIANTS["lsp0"], gamma=16, block_budget=24)
    want = jax_jit_search(idx, JaxStaticConfig(**kw), impl="ref")(jqb)
    pqb = QueryBatch(torch.from_numpy(np.array(jqb.tids)), torch.from_numpy(np.array(jqb.ws)), jqb.vocab)
    got = search_retrieve(from_arrays(idx, "cpu"), pqb, StaticConfig(**kw))
    _assert_same(got, want)
    scores = np.asarray(want.scores)
    assert ((scores[:, :-1] == scores[:, 1:]) & (scores[:, 1:] > 0)).any()  # the results hold ties
