"""Sharded serving (host loop) against the JAX package, on the CPU.

The port's ``sharded_retrieve`` against JAX's on the same shards (JAX's cut,
carried across with ``index.convert.from_arrays``) for lsp0/1/2 and sp, 2 and
3 shards (3 cuts the 32-superblock tiny index raggedly), a binding block
budget, a mixed per-row batch and a tie-heavy corpus; the port's sharded
backend against its own ``local`` backend; the refused configurations; the
facade (``build(shards=)``, ``load`` of a set JAX saved, a mismatched
``shards=``, the promotion and save refusals, a short op-log replay local
against sharded after ``build(shards=2).mutable()``); and the engine's
``swap_index`` of a shard set (one epoch for every shard, an in-flight batch
on the old set, a failing shard load or build leaving the old set serving).

Tolerance: ids, both counters and the ``shard_*`` counters equal; θ, the
per-shard θ and scores within rtol 1e-5, atol 1e-5 against JAX (float32 sums
in another order). The port's sharded and local backends run the same
arithmetic on the same device: equal bits.
"""

import threading

import numpy as np
import pytest
import torch

from repro.core import make_query_batch as jax_make_query_batch
from repro.core.config import DynamicParams as JaxDynamicParams, RetrievalConfig as JaxRetrievalConfig
from repro.core.config import StaticConfig as JaxStaticConfig
from repro.distributed.retrieval import shard_index as jax_shard_index
from repro.distributed.sharded import ShardedRetriever as JaxShardedRetriever
from repro.index import store as jax_store
from repro.index.builder import IndexBuildConfig as JaxIndexBuildConfig, build_index as jax_build_index
from repro_torch.api import Retriever, SearchRequest
from repro_torch.core.config import DynamicParams, RetrievalConfig, StaticConfig
from repro_torch.core.lsp import search_retrieve
from repro_torch.core.query import make_query_batch
from repro_torch.data.synthetic import CorpusConfig, make_corpus, make_queries
from repro_torch.distributed.retrieval import shard_index
from repro_torch.distributed.sharded import ShardedRetriever, sharded_retrieve
from repro_torch.index import store
from repro_torch.index.builder import IndexBuildConfig
from repro_torch.index.convert import from_arrays
from repro_torch.serve import RetrievalEngine

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
CASES = {
    "lsp0": (dict(variant="lsp0", gamma=8, gamma0=2), dict(k=10, beta=0.5)),
    "lsp1": (dict(variant="lsp1", gamma=8, gamma0=4), dict(k=10, mu=0.3, beta=0.5)),
    "lsp2": (dict(variant="lsp2", gamma=8, gamma0=4), dict(k=10, mu=0.3, eta=0.8)),
    "sp": (dict(variant="sp", gamma=16, gamma0=4), dict(k=10, mu=0.1, eta=0.5, beta=1.0)),
    "lsp0_block_budget": (dict(variant="lsp0", gamma=32, gamma0=4, block_budget=16), dict(k=10, beta=0.5)),
}
SHARD_COUNTS = [2, 3]


def _mixed_rows(q):
    return [dict(k=1 + (i * 3) % 10, mu=(0.2, 0.5, 0.9)[i % 3], eta=(0.7, 1.0)[i % 2],
                 beta=(0.33, 0.6, 1.0)[i % 3]) for i in range(q)]


def _jax_sharded(jax_shards, scfg_kw, ns_true):
    """JAX's host-loop ``sharded_retrieve`` under jit (its ``ShardedRetriever``), impl="ref"."""
    return JaxShardedRetriever(jax_shards, JaxStaticConfig(**scfg_kw), impl="ref", ns_true=ns_true)


def _assert_matches_jax(got, want, ctx=""):
    """Every field of ShardedRetrievalResult: integers equal, floats within TOL."""
    for f in got._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f in ("scores", "theta", "shard_theta"):
            np.testing.assert_allclose(g, w, err_msg=f"{ctx}: {f}", **TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{ctx}: {f}")


def _assert_same(a, b, fields=("doc_ids", "scores", "theta", "n_superblocks_visited", "n_blocks_scored")):
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f).numpy(), getattr(b, f).numpy(), err_msg=f)


@pytest.fixture(scope="module")
def jax_shards(tiny_index):
    return {n: jax_shard_index(tiny_index, n) for n in SHARD_COUNTS}


@pytest.fixture(scope="module")
def port_index(tiny_index):
    return from_arrays(tiny_index, CPU)


@pytest.fixture(scope="module")
def qbs(tiny_qb):
    """The tiny queries for both packages."""
    qb = make_query_batch(list(zip(np.asarray(tiny_qb.tids), np.asarray(tiny_qb.ws))), tiny_qb.vocab, device=CPU)
    return tiny_qb, qb


@pytest.mark.parametrize("n", SHARD_COUNTS, ids=lambda n: f"{n}-shards")
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_retrieve_equals_jax(case, n, tiny_index, jax_shards, qbs):
    scfg_kw, dyn_kw = CASES[case]
    jqb, qb = qbs
    want = _jax_sharded(jax_shards[n], scfg_kw, tiny_index.n_superblocks)(jqb, JaxDynamicParams(**dyn_kw))
    shards = [from_arrays(s, CPU) for s in jax_shards[n]]
    got = sharded_retrieve(shards, qb, StaticConfig(**scfg_kw), impl="ref", ns_true=tiny_index.n_superblocks,
                           dyn=DynamicParams(**dyn_kw))
    _assert_matches_jax(got, want, f"{case}, {n} shards")
    assert got.shard_candidates.shape == (qb.tids.shape[0], n)


@pytest.mark.parametrize("n", SHARD_COUNTS, ids=lambda n: f"{n}-shards")
def test_mixed_per_row_params_equal_jax(n, tiny_index, jax_shards, qbs):
    jqb, qb = qbs
    rows = _mixed_rows(qb.tids.shape[0])
    scfg = dict(variant="lsp2", gamma=8, gamma0=4)
    want = _jax_sharded(jax_shards[n], scfg, tiny_index.n_superblocks)(jqb, [JaxDynamicParams(**r) for r in rows])
    got = sharded_retrieve([from_arrays(s, CPU) for s in jax_shards[n]], qb, StaticConfig(**scfg), impl="ref",
                           ns_true=tiny_index.n_superblocks, dyn=[DynamicParams(**r) for r in rows])
    _assert_matches_jax(got, want, f"mixed rows, {n} shards")
    assert len(set(got.doc_ids.ne(-1).sum(dim=1).tolist())) > 1  # the rows really have their own k


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_backend_equals_local(case, port_index, qbs):
    """The port's sharded backend against its own local backend on the
    unsharded index: the same bits, at 2 and 3 shards, and a mixed batch."""
    scfg_kw, dyn_kw = CASES[case]
    _, qb = qbs
    scfg = StaticConfig(**scfg_kw)
    for dyn in (DynamicParams(**dyn_kw), [DynamicParams(**r) for r in _mixed_rows(qb.tids.shape[0])]):
        want = search_retrieve(port_index, qb, scfg, dyn, impl="ref")
        for n in SHARD_COUNTS:
            got = ShardedRetriever(port_index, scfg, n_shards=n, impl="ref")(qb, dyn)
            _assert_same(got, want)
            np.testing.assert_array_equal(got.shard_superblocks.sum(dim=1).numpy(),
                                          want.n_superblocks_visited.numpy())


def _tripled_corpus():
    """341 distinct docs, each three times (1,023 docs), constant weights:
    equal scores everywhere, at both merges and across shard boundaries."""
    rng = np.random.default_rng(5)
    vocab = 96
    base = [np.sort(rng.choice(vocab, int(rng.integers(4, 9)), replace=False)) for _ in range(341)]
    docs = [d for d in base for _ in range(3)]
    doc_ptr = np.zeros(len(docs) + 1, np.int64)
    np.cumsum([len(d) for d in docs], out=doc_ptr[1:])
    tids = np.concatenate(docs).astype(np.int32)
    queries = [(base[i].astype(np.int32), np.ones(len(base[i]), np.float32)) for i in range(0, 64, 8)]
    return doc_ptr, tids, np.ones_like(tids, np.float32), vocab, queries


@pytest.fixture(scope="module")
def tripled():
    doc_ptr, tids, ws, vocab, queries = _tripled_corpus()
    idx = jax_build_index(doc_ptr, tids, ws, vocab, JaxIndexBuildConfig(b=4, c=8, kmeans_iters=1, d_proj=16))
    return idx, vocab, queries


@pytest.mark.parametrize("block_budget", [0, 24], ids=["full-width", "binding-budget"])
def test_tie_heavy_corpus_equals_jax_and_local(tripled, block_budget):
    idx, vocab, queries = tripled
    n = 3
    scfg_kw = dict(variant="lsp1", gamma=max(2, idx.n_superblocks // 2), gamma0=2, block_budget=block_budget)
    dyn_kw = dict(k=10, mu=0.5, beta=1.0)
    jqb = jax_make_query_batch(queries, vocab)
    qb = make_query_batch(queries, vocab, device=CPU)
    jshards = jax_shard_index(idx, n)
    want = _jax_sharded(jshards, scfg_kw, idx.n_superblocks)(jqb, JaxDynamicParams(**dyn_kw))
    got = sharded_retrieve([from_arrays(s, CPU) for s in jshards], qb, StaticConfig(**scfg_kw), impl="ref",
                           ns_true=idx.n_superblocks, dyn=DynamicParams(**dyn_kw))
    _assert_matches_jax(got, want, f"tripled corpus, block_budget {block_budget}")
    local = search_retrieve(from_arrays(idx, CPU), qb, StaticConfig(**scfg_kw), DynamicParams(**dyn_kw), impl="ref")
    _assert_same(got, local)
    # the ties are real: the k-th score repeats, and its equals lie in more than one shard
    span = idx.n_docs + 1
    pos_of = np.full(span, -1)
    remap = np.asarray(idx.doc_remap)
    pos_of[remap[remap < idx.n_docs]] = np.flatnonzero(remap < idx.n_docs)
    per_shard_docs = jshards[0].n_superblocks * idx.c * idx.b
    straddles = 0
    for row in range(len(queries)):
        scores = got.scores[row].numpy()
        tied = got.doc_ids[row].numpy()[scores == scores[-1]]
        if len(tied) > 1 and len(set(pos_of[tied] // per_shard_docs)) > 1:
            straddles += 1
    assert straddles > 0, "no tie at the k boundary straddles a shard boundary"
    if block_budget:
        assert (got.n_blocks_scored <= 24 + scfg_kw["gamma0"] * idx.c).all()


def test_unsupported_configs_raise(port_index, tiny_index):
    for cfg, match in ((dict(variant="bmp"), "bmp"), (dict(variant="exact"), "exact"),
                       (dict(doc_layout="flat"), "fwd")):
        with pytest.raises(ValueError, match=match) as port_err:
            ShardedRetriever(port_index, StaticConfig(**cfg), n_shards=2)
        with pytest.raises(ValueError) as jax_err:
            JaxShardedRetriever(tiny_index, JaxStaticConfig(**cfg), n_shards=2)
        assert str(port_err.value) == str(jax_err.value)
    unknown = StaticConfig()
    object.__setattr__(unknown, "variant", "lsp9")  # past StaticConfig's own check
    with pytest.raises(ValueError, match="unknown variant 'lsp9'"):
        ShardedRetriever(port_index, unknown, n_shards=2)
    with pytest.raises(ValueError, match="impl"):
        ShardedRetriever(port_index, StaticConfig(), n_shards=2, impl="legacy")
    with pytest.raises(ValueError, match="n_shards"):
        ShardedRetriever(port_index, StaticConfig())


# ---- the facade ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_sharded_dir(tiny_index, tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("jax_sharded") / "set")
    jax_store.save_sharded_index(directory, tiny_index, 3)
    return directory


def test_build_with_shards_serves_the_sharded_backend(tiny_corpus):
    _, corpus, queries = tiny_corpus
    bcfg = IndexBuildConfig(b=8, c=8, kmeans_iters=2)
    scfg = StaticConfig(variant="lsp0", gamma=8, gamma0=2)
    local = Retriever.build(corpus, scfg, build_cfg=bcfg, device="cpu")
    sharded = Retriever.build(corpus, scfg, build_cfg=bcfg, shards=2, device="cpu")
    assert (local.backend_name, sharded.backend_name) == ("local", "sharded")
    requests = [SearchRequest(t, w) for t, w in queries]
    for a, b in zip(local.search_batch(requests), sharded.search_batch(requests)):
        np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
        np.testing.assert_array_equal(a.scores, b.scores)
        assert (a.theta, a.n_superblocks_visited, a.n_blocks_scored) == (
            b.theta, b.n_superblocks_visited, b.n_blocks_scored)
        assert a.shard_candidates is None and b.shard_candidates.shape == (2,)
        assert b.shard_candidates.sum() == min(scfg.gamma, local.index.n_superblocks)


def test_load_of_a_set_jax_saved_equals_jax_sharded_retriever(jax_sharded_dir, tiny_corpus):
    from repro.api import SearchRequest as JaxSearchRequest
    from repro.api import Retriever as JaxRetriever

    _, _, queries = tiny_corpus
    scfg = dict(variant="lsp0", gamma=8, gamma0=2, k_max=10)
    jretr = JaxRetriever.load(jax_sharded_dir, JaxStaticConfig(**scfg), impl="ref")
    assert isinstance(jretr._backend, JaxShardedRetriever)
    want = jretr.search_batch([JaxSearchRequest(t, w) for t, w in queries])
    retr = Retriever.load(jax_sharded_dir, StaticConfig(**scfg), impl="ref", device="cpu")
    assert retr.backend_name == "sharded" and isinstance(retr._backend, ShardedRetriever)
    got = retr.search_batch([SearchRequest(t, w) for t, w in queries])
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids, err_msg=f"query {i}")
        np.testing.assert_allclose(g.scores, w.scores, **TOL)
        np.testing.assert_allclose(g.theta, w.theta, **TOL)
        assert (g.n_superblocks_visited, g.n_blocks_scored) == (w.n_superblocks_visited, w.n_blocks_scored)
        np.testing.assert_array_equal(g.shard_candidates, w.shard_candidates)


def test_mismatched_shards_raise_what_jax_raises(jax_sharded_dir):
    from repro.api import Retriever as JaxRetriever

    with pytest.raises(ValueError) as jax_err:
        JaxRetriever.load(jax_sharded_dir, shards=2)
    with pytest.raises(ValueError) as port_err:
        Retriever.load(jax_sharded_dir, shards=2, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    assert Retriever.load(jax_sharded_dir, shards=3, device="cpu")._backend.n_shards == 3


def test_single_directory_reshards_in_memory(tiny_index, tmp_path):
    directory = str(tmp_path / "single")
    jax_store.save_index(directory, tiny_index)
    retr = Retriever.load(directory, shards=3, device="cpu")
    assert retr.backend_name == "sharded" and retr._backend.n_shards == 3
    assert retr._backend.ns_true == tiny_index.n_superblocks


def test_a_loaded_set_refuses_promotion_and_save(jax_sharded_dir, tiny_index, tmp_path):
    from repro.api import Retriever as JaxRetriever
    from repro.index.store import ShardedPromotionError as JaxShardedPromotionError

    retr = Retriever.load(jax_sharded_dir, device="cpu")
    jretr = JaxRetriever.load(jax_sharded_dir)
    with pytest.raises(store.ShardedPromotionError, match="sharded") as ei:
        retr.add([(np.array([1, 2], np.int32), np.ones(2, np.float32))])
    with pytest.raises(JaxShardedPromotionError) as jei:
        jretr.mutable()
    assert isinstance(ei.value, ValueError)
    assert ei.value.workaround == jei.value.workaround
    assert "Retriever.load" in ei.value.workaround and "Retriever.build" in ei.value.workaround
    with pytest.raises(store.ShardedPromotionError, match="save_sharded_index") as ei:
        retr.save(str(tmp_path / "never-written"))
    assert "save_sharded_index" in ei.value.workaround
    assert not (tmp_path / "never-written").exists()
    # a bare shard list refuses both too
    listed = Retriever.from_index(shard_index(from_arrays(tiny_index, CPU), 2), device="cpu")
    assert listed.backend_name == "sharded"
    with pytest.raises(store.ShardedPromotionError):
        listed.mutable()


def test_replay_local_against_sharded_after_build_with_shards():
    """``build(corpus, shards=2).mutable()`` keeps the unsharded main
    generation and serves it through the sharded backend: an op log of adds,
    deletes and compactions answers as the local replica's, bit for bit."""
    ccfg = CorpusConfig(n_docs=160, vocab=128, n_topics=6, doc_len_mean=12, query_len_mean=6, seed=21)
    corpus = make_corpus(ccfg)
    queries = make_queries(ccfg, corpus, 6, seed=9)
    bcfg = IndexBuildConfig(b=4, c=8, kmeans_iters=2, build_avg=False)
    k = 5
    replicas = {}
    for backend, shards in (("local", 0), ("sharded", 2)):
        retr = Retriever.build(corpus, build_cfg=bcfg, shards=shards, params=DynamicParams(k=k), device="cpu")
        assert retr.backend_name == backend
        replicas[backend] = retr.mutable()
    assert replicas["sharded"]._adapter._mutable.state().main is not None
    assert isinstance(replicas["sharded"]._adapter._mutable.state().runtime, ShardedRetriever)
    rng = np.random.default_rng(1000)
    live = list(range(ccfg.n_docs))
    qb = make_query_batch(queries, corpus.vocab, device=CPU)
    ops = [("search",), ("add", 3), ("search",), ("delete",), ("search",), ("compact",), ("search",),
           ("add", 2), ("delete",), ("search",), ("compact",), ("search",)]
    for step, op in enumerate(ops):
        if op[0] == "add":
            docs = [(rng.choice(corpus.vocab, 5, replace=False).astype(np.int32),
                     rng.uniform(0.1, 3.0, 5).astype(np.float32)) for _ in range(op[1])]
            ids = [r._adapter.add_docs(docs)[0] for r in replicas.values()]
            assert ids[0] == ids[1]
            live += ids[0]
        elif op[0] == "delete":
            victim = live.pop(int(rng.integers(0, len(live))))
            for r in replicas.values():
                r._adapter.delete_docs([victim])
        elif op[0] == "compact":
            for r in replicas.values():
                r._adapter.compact()
        else:
            a, b = (r._adapter(qb, [DynamicParams(k=k)] * len(queries)) for r in replicas.values())
            for f in ("doc_ids", "scores", "theta"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"step {step}: {f}")
            assert b.shard_candidates.shape == (len(queries), 2)


# ---- the engine ---------------------------------------------------------------------------------

ENGINE_CFG = RetrievalConfig(variant="lsp0", k=10, gamma=12, gamma0=4, beta=0.5)
N_SHARDS = 3


def _gen(seed: int):
    """One corpus generation at the JAX sharded-serving suite's scale: (vocab, index, queries)."""
    ccfg = CorpusConfig(n_docs=768, vocab=128, n_topics=6, seed=seed)
    corpus = make_corpus(ccfg)
    idx = Retriever.build(corpus, build_cfg=IndexBuildConfig(b=4, c=8, kmeans_iters=1, d_proj=16),
                          device="cpu").index
    return corpus.vocab, idx, make_queries(ccfg, corpus, 6, seed=99)


@pytest.fixture(scope="module")
def gens():
    return _gen(0), _gen(1)


def _factory(ix):
    return ShardedRetriever(ix, ENGINE_CFG, n_shards=N_SHARDS, impl="ref")


def _expected(idx, t, w, vocab):
    qb = make_query_batch([(t, w)], vocab, device=CPU)
    res = search_retrieve(idx, qb, ENGINE_CFG.static(), ENGINE_CFG.dynamic(), impl="ref")
    return res.doc_ids[0].numpy(), res.scores[0].numpy()


def _engine(retriever, vocab, **kw):
    return RetrievalEngine(retriever, vocab, max_batch=2, nq_max=64, cache_size=16, retriever_factory=_factory,
                           **kw)


def test_swap_index_of_a_sharded_directory_flips_every_shard_under_one_epoch(gens, tmp_path):
    (vocab, idx0, queries), (_, idx1, _) = gens
    d0, d1 = str(tmp_path / "gen0"), str(tmp_path / "gen1")
    store.save_sharded_index(d0, idx0, N_SHARDS)
    store.save_sharded_index(d1, idx1, N_SHARDS)
    eng = _engine(_factory(store.load_index_auto(d0, device="cpu")), vocab)
    try:
        t, w = queries[0]
        r0 = eng.search(SearchRequest(t, w)).result(timeout=120)
        np.testing.assert_array_equal(r0.doc_ids, _expected(idx0, t, w, vocab)[0])
        np.testing.assert_array_equal(r0.scores, _expected(idx0, t, w, vocab)[1])
        assert eng.search(SearchRequest(t, w)).result(timeout=120).cache_hit  # epoch 0's entry
        assert eng.swap_index(d1) == eng.epoch == 1
        r1 = eng.search(SearchRequest(t, w)).result(timeout=120)
        assert not r1.cache_hit and r1.epoch == 1  # the old entry never hits again
        want = _expected(idx1, t, w, vocab)
        np.testing.assert_array_equal(r1.doc_ids, want[0])
        np.testing.assert_array_equal(r1.scores, want[1])
        assert not (np.array_equal(r0.doc_ids, r1.doc_ids) and np.array_equal(r0.scores, r1.scores))
        assert isinstance(eng.retriever, ShardedRetriever) and eng.retriever.n_shards == N_SHARDS
        assert r1.shard_candidates.shape == (N_SHARDS,)
    finally:
        eng.shutdown()


def test_an_inflight_batch_completes_on_the_old_shard_set(gens):
    (vocab, idx0, queries), (_, idx1, _) = gens
    old = _factory(idx0)
    entered, release = threading.Event(), threading.Event()

    def gated_old(qb, dyn=None):
        entered.set()
        release.wait(timeout=60)
        return old(qb, dyn)

    gated_old.supports_dynamic = True
    gated_old.device = CPU
    eng = _engine(gated_old, vocab, max_wait_ms=0.0)
    try:
        t, w = queries[1]
        fut = eng.search(SearchRequest(t, w))
        assert entered.wait(timeout=60)  # the worker is inside the old shard set
        assert eng.swap_index(idx1, warm=False) == 1  # the swap lands mid-flight
        release.set()
        got = fut.result(timeout=120)
        np.testing.assert_array_equal(got.doc_ids, _expected(idx0, t, w, vocab)[0])
        assert got.epoch == 0
        again = eng.search(SearchRequest(t, w)).result(timeout=120)
        assert not again.cache_hit  # the old batch's fill was dropped
        np.testing.assert_array_equal(again.doc_ids, _expected(idx1, t, w, vocab)[0])
    finally:
        release.set()
        eng.shutdown()


def test_a_failing_shard_load_or_build_leaves_the_old_set_serving(gens, tmp_path):
    (vocab, idx0, queries), (_, idx1, _) = gens
    d1 = str(tmp_path / "gen1")
    store.save_sharded_index(d1, idx1, N_SHARDS)
    np.save(str(tmp_path / "gen1" / "shard-00001" / "doc_remap.npy"), np.zeros(3, np.float64))  # a broken leaf
    eng = _engine(_factory(idx0), vocab)
    try:
        t, w = queries[2]
        before = eng.search(SearchRequest(t, w)).result(timeout=120)
        with pytest.raises(store.IndexStoreError):
            eng.swap_index(d1)
        assert eng.epoch == 0 and eng.stats.summary()["swaps"] == 0

        def exploding_factory(ix):
            raise RuntimeError("shard build failed")

        eng.retriever_factory = exploding_factory
        with pytest.raises(RuntimeError, match="shard build failed"):
            eng.swap_index(idx1)
        assert eng.epoch == 0
        after = eng.search(SearchRequest(t, w)).result(timeout=120)
        np.testing.assert_array_equal(before.doc_ids, after.doc_ids)
        np.testing.assert_array_equal(before.scores, after.scores)
        assert eng.stats.summary()["failures"] == 0
    finally:
        eng.shutdown()
