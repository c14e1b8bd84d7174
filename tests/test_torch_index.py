"""The port's index layer against the JAX package's: carry-across of a built
index, the index build's bytes given the same document order, its own k-means by
recall, and the numpy pieces (corpus generator, packing, quantization)."""

import jax
import numpy as np
import pytest
import torch

import repro.index.clustering as jax_clustering
from repro.core.exact import retrieve_exact as jax_retrieve_exact
from repro.core import jit_search as jax_jit_search
from repro.core.config import DynamicParams as JaxDynamicParams, StaticConfig as JaxStaticConfig
from repro.core.query import make_query_batch as jax_make_query_batch
from repro.data.synthetic import CorpusConfig as JaxCorpusConfig
from repro.data.synthetic import make_corpus as jax_make_corpus, make_queries as jax_make_queries
from repro.eval.metrics import recall_vs_oracle as jax_recall
from repro.index import pack as jax_pack, quantize as jax_quantize
from repro.index.builder import IndexBuildConfig as JaxBuildConfig, build_index as jax_build_index
from repro_torch.core.bounds import unpack_strided
from repro_torch.core.config import DynamicParams, StaticConfig
from repro_torch.core.exact import retrieve_exact
from repro_torch.core.lsp import search_retrieve
from repro_torch.core.query import make_query_batch
from repro_torch.data import synthetic
from repro_torch.eval.metrics import recall_vs_oracle
from repro_torch.index import clustering, pack, quantize
from repro_torch.index.builder import IndexBuildConfig, _numpy_mean_lastaxis, build_index
from repro_torch.index.convert import from_arrays

CPU = torch.device("cpu")


def _leaves(x, prefix=""):
    """path -> numpy array / Python scalar / None for an index-like NamedTuple
    of either package."""
    out = {}
    for name, v in zip(x._fields, x):
        key = prefix + name
        if hasattr(v, "_fields"):
            out.update(_leaves(v, key + "."))
        elif v is None or isinstance(v, (int, float)):
            out[key] = v
        elif isinstance(v, torch.Tensor):
            out[key] = v.cpu().numpy()
        else:
            out[key] = np.asarray(v)
    return out


def _assert_leaves_equal(port_index, jax_index):
    want = _leaves(jax_index)
    got = _leaves(port_index)
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            if w.dtype == np.uint32:
                g = g.view(np.uint32)  # packed words travel as int32 views
            assert g.dtype == w.dtype and g.shape == w.shape, (key, g.dtype, w.dtype, g.shape, w.shape)
            assert g.tobytes() == w.tobytes(), key
        else:
            assert type(g) is type(w) and g == w, (key, g, w)


def _numpy_leaves(jax_index):
    return jax.tree_util.tree_map(np.asarray, jax_index)


def test_convert_carries_every_leaf(tiny_index):
    _assert_leaves_equal(from_arrays(_numpy_leaves(tiny_index), CPU), tiny_index)


def test_convert_global_scale_stays_float(tiny_corpus):
    _, corpus, _ = tiny_corpus
    cfg = JaxBuildConfig(b=8, c=8, kmeans_iters=1, quant_granularity="global")
    jax_idx = jax_build_index(corpus.doc_ptr, corpus.tids, corpus.ws, corpus.vocab, cfg)
    port = from_arrays(_numpy_leaves(jax_idx), CPU)
    assert isinstance(port.sb_bounds.scale, float)
    _assert_leaves_equal(port, jax_idx)


@pytest.mark.parametrize("cfg_kw", [
    dict(b=8, c=8, kmeans_iters=3),
    dict(b=4, c=16, kmeans_iters=1, quant_granularity="global", bound_bits=8, doc_bits=16, lane_pad=16),
])
def test_builder_byte_equal_given_the_jax_doc_order(tiny_corpus, tiny_index, monkeypatch, cfg_kw):
    _, corpus, _ = tiny_corpus
    remap = np.asarray(tiny_index.doc_remap)
    monkeypatch.setattr(jax_clustering, "block_order", lambda *a, **k: remap)
    monkeypatch.setattr(clustering, "block_order", lambda *a, **k: torch.from_numpy(remap.copy()))
    args = (corpus.doc_ptr, corpus.tids, corpus.ws, corpus.vocab)
    jax_idx = jax_build_index(*args, JaxBuildConfig(**cfg_kw))
    port = build_index(*args, IndexBuildConfig(**cfg_kw), device=CPU)
    _assert_leaves_equal(port, jax_idx)


def test_builder_own_kmeans_recall_within_tolerance(tiny_corpus, tiny_index):
    """k-means in torch rounds differently, so the doc order may differ; lsp0
    recall@10 against each package's own exact oracle must stay within 0.05."""
    cfg, corpus, _ = tiny_corpus
    queries = jax_make_queries(cfg, corpus, 64, seed=3)
    port = build_index(corpus.doc_ptr, corpus.tids, corpus.ws, corpus.vocab,
                       IndexBuildConfig(b=8, c=8, kmeans_iters=3), device=CPU)
    scfg = dict(variant="lsp0", gamma=8, gamma0=2, k_max=10)
    qb = make_query_batch(queries, corpus.vocab, device=CPU)
    got = search_retrieve(port, qb, StaticConfig(**scfg), DynamicParams(k=10)).doc_ids.numpy()
    oracle = retrieve_exact(port, qb, 10)[0].numpy()
    jqb = jax_make_query_batch(queries, corpus.vocab)
    jgot = jax_jit_search(tiny_index, JaxStaticConfig(**scfg), impl="ref")(jqb, JaxDynamicParams(k=10))
    joracle = jax_retrieve_exact(tiny_index, jqb, 10)[0]
    r_port = recall_vs_oracle(got, oracle)
    r_jax = jax_recall(np.asarray(jgot.doc_ids), np.asarray(joracle))
    assert abs(r_port - r_jax) <= 0.05, (r_port, r_jax)


def test_kmeans_pp_seeding_draws_like_numpy_choice():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((500, 16)).astype(np.float32)
    want = jax_clustering._kmeans_pp_init(x, 24, seed=5)
    got = clustering._kmeans_pp_init(torch.from_numpy(x), 24, np.random.default_rng(5))
    np.testing.assert_array_equal(got.numpy(), want)


def test_synthetic_corpus_and_queries_match():
    kw = dict(n_docs=3000, vocab=700, n_topics=9, seed=4)
    want = jax_make_corpus(JaxCorpusConfig(**kw))
    got = synthetic.make_corpus(synthetic.CorpusConfig(**kw))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    wq = jax_make_queries(JaxCorpusConfig(**kw), want, 12)
    gq = synthetic.make_queries(synthetic.CorpusConfig(**kw), got, 12)
    for (wt, ww), (gt, gw) in zip(wq, gq):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gw, ww)


@pytest.mark.parametrize("bits,granule", [(4, 128), (4, 2), (8, 4), (8, 128)])
def test_pack_rows_strided_matches_numpy(bits, granule):
    rng = np.random.default_rng(bits + granule)
    q = rng.integers(0, 1 << bits, (37, 1000)).astype(np.uint8)
    want = jax_pack.pack_rows_strided(q, bits, granule)
    got = pack.pack_rows_strided(torch.from_numpy(q), bits, granule)
    assert got.numpy().view(np.uint32).tobytes() == want.tobytes()
    back = unpack_strided(got, bits, granule)[:, :1000]
    np.testing.assert_array_equal(back.numpy(), q)


def test_quantizers_match_numpy():
    rng = np.random.default_rng(0)
    w = (rng.lognormal(size=(64, 300)) * (rng.random((64, 300)) < 0.3)).astype(np.float32)
    w[3] = 0.0  # an all-zero row gets scale 1
    tw = torch.from_numpy(w)
    for bits in (4, 8):
        q, s = quantize.quantize_bounds_per_row(tw, bits)
        wq, ws = jax_quantize.quantize_bounds_per_row(w, bits)
        assert q.numpy().tobytes() == wq.tobytes() and s.numpy().tobytes() == ws.tobytes()
        q, s = quantize.quantize_bounds(tw, bits)
        wq, ws = jax_quantize.quantize_bounds(w, bits)
        assert q.numpy().tobytes() == wq.tobytes() and s == ws
    flat = w[w > 0]
    blk = rng.integers(0, 40, flat.shape[0])
    for bits in (8, 16):
        q, s = quantize.quantize_weights(torch.from_numpy(flat), bits)
        wq, ws = jax_quantize.quantize_weights(flat, bits)
        assert q.numpy().tobytes() == wq.tobytes() and s == ws
        q, s = quantize.quantize_weights_per_block(torch.from_numpy(flat), torch.from_numpy(blk), 41, bits)
        wq, ws = jax_quantize.quantize_weights_per_block(flat, blk, 41, bits)
        assert q.numpy().tobytes() == wq.tobytes() and s.numpy().tobytes() == ws.tobytes()


@pytest.mark.parametrize("n", [4, 8, 16, 24, 200])
def test_superblock_mean_sums_in_numpys_order(n):
    rng = np.random.default_rng(n)
    x = (rng.lognormal(size=(4000, 3, n)) * (rng.random((4000, 3, n)) < 0.5)).astype(np.float32)
    got = _numpy_mean_lastaxis(torch.from_numpy(x)).numpy()
    assert got.tobytes() == x.mean(axis=2).tobytes()
