"""The port's mutable index against the JAX package's: two replicas (one per
package) replay the same seeded op logs (adds, deletes, compactions,
searches) and agree at every search; the port's compacted generation equals
a from-scratch rebuild of the logical corpus bit for bit; adds are visible at
once and deletes never surface; the host pieces (``_live_csr``,
``corpus_from_index``, ``merge_mutable_topk``, ``score_delta_docs``) are
byte-equal to JAX's; and the engine serves concurrent adds, deletes and
searches across background compactions with no stale or lost result.

Compactions rebuild with ``block_order`` pinned to the JAX package's k-means
on the same inputs: the port's own k-means rounds differently, and the
index build is byte-equal only given the same document order."""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

import repro.index.clustering as jax_clustering
from repro.api import Retriever as JaxRetriever
from repro.core.config import DynamicParams as JaxDynamicParams, StaticConfig as JaxStaticConfig
from repro.core.exact import score_delta_docs as jax_score_delta_docs
from repro.core.merge import merge_mutable_topk as jax_merge_mutable_topk
from repro.core.query import make_query_batch as jax_make_query_batch
from repro.data.synthetic import CorpusConfig, make_corpus, make_queries
from repro.index import mutable as jax_mutable
from repro.index.builder import IndexBuildConfig as JaxIndexBuildConfig, build_index as jax_build_index
from repro_torch.api import DynamicParams, Retriever, SearchRequest, StaticConfig
from repro_torch.core.exact import score_delta_docs
from repro_torch.core.merge import merge_mutable_topk
from repro_torch.core.query import make_query_batch
from repro_torch.distributed.retrieval import shard_index
from repro_torch.index import clustering, mutable
from repro_torch.index.builder import IndexBuildConfig, build_index
from repro_torch.index.convert import from_arrays
from repro_torch.index.store import ShardedPromotionError, save_mutable_index
from repro_torch.serve import ServeStats

K = 5
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
BUILD = dict(b=4, c=8, kmeans_iters=2, build_avg=False)
CCFG = CorpusConfig(n_docs=160, vocab=128, n_topics=6, doc_len_mean=12, query_len_mean=6, seed=21)


@pytest.fixture(scope="module")
def mut_corpus():
    corpus = make_corpus(CCFG)
    queries = make_queries(CCFG, corpus, 6, seed=9)
    return corpus, queries


@pytest.fixture
def jax_order(monkeypatch):
    """The port's builds take the JAX package's document order on the same inputs."""

    def order(*args, device=None, **kw):
        return torch.from_numpy(np.asarray(jax_clustering.block_order(*args, **kw)).copy())

    monkeypatch.setattr(clustering, "block_order", order)


def _rand_doc(rng, vocab):
    n = int(rng.integers(3, 9))
    tids = rng.choice(vocab, size=n, replace=False).astype(np.int32)
    ws = rng.uniform(0.1, 3.0, size=n).astype(np.float32)
    return tids, ws


def _schedule(rng, vocab, n_ops=10, max_deletes=10):
    """A reproducible interleaving of add/delete/compact/search ops (as the JAX
    package's tests/test_mutable_index.py builds them, plus deletes of a
    query's current rank-0 doc, so tombstones reach the top-k). Delete ops
    name the j-th live doc or the top doc of query j, so the schedule
    replays identically on any replica that returns the same ids."""
    ops, deletes = [("search",)], 0
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.4:
            ops.append(("add", [_rand_doc(rng, vocab) for _ in range(int(rng.integers(1, 4)))]))
        elif r < 0.6 and deletes < max_deletes:
            ops.append(("delete_nth" if r < 0.5 else "delete_top", int(rng.integers(0, 10**6))))
            deletes += 1
        elif r < 0.75:
            ops.append(("compact",))
        ops.append(("search",))
    ops.append(("compact",))
    ops.append(("search",))
    return ops


class _Replica:
    """One promoted retriever (of either package) + the live-id mirror the
    schedule indexes into."""

    def __init__(self, retr, queries, vocab, port):
        self.retr = retr.mutable()
        self.adapter = retr._adapter
        self.live = list(range(CCFG.n_docs))
        self.port = port
        make = make_query_batch if port else jax_make_query_batch
        self.qb = make(queries, vocab, **({"device": CPU} if port else {}))
        self.params = DynamicParams(k=K) if port else JaxDynamicParams(k=K)

    def apply(self, op):
        kind = op[0]
        if kind == "add":
            ids, _ = self.adapter.add_docs(op[1])
            self.live.extend(ids)
        elif kind == "delete_nth":
            self.adapter.delete_docs([self.live.pop(op[1] % len(self.live))])
        elif kind == "delete_top":
            ids = self.search()[0]
            victim = int(ids[op[1] % ids.shape[0], 0])
            self.live.remove(victim)
            self.adapter.delete_docs([victim])
        elif kind == "compact":
            self.adapter.compact()

    def search(self):
        out = self.adapter(self.qb, [self.params] * int(self.qb.tids.shape[0]))
        return tuple(np.asarray(x) for x in (out.doc_ids, out.scores, out.theta, out.n_superblocks_visited,
                                             out.n_blocks_scored))


def _port_replica(corpus, queries, scfg=None):
    retr = Retriever.build(corpus, scfg, build_cfg=IndexBuildConfig(**BUILD), params=DynamicParams(k=K),
                           device=CPU)
    return _Replica(retr, queries, corpus.vocab, port=True)


def _jax_replica(corpus, queries, scfg):
    retr = JaxRetriever.build(corpus, JaxStaticConfig(**scfg), build_cfg=JaxIndexBuildConfig(**BUILD),
                              backend="local", params=JaxDynamicParams(k=K))
    return _Replica(retr, queries, corpus.vocab, port=False)


# ---- replay parity: a JAX replica and a port replica, the same op logs ---------------


@pytest.mark.parametrize("seed,k_max", [(0, K), (1, 16), (2, 16)])
def test_replay_parity_against_jax(mut_corpus, jax_order, seed, k_max):
    """k_max = k: every tombstone saturates the overfetch; k_max = 16: room for it."""
    corpus, queries = mut_corpus
    ops = _schedule(np.random.default_rng(1000 + seed), corpus.vocab)
    scfg = dict(variant="lsp0", gamma=5, gamma0=5, k_max=k_max)
    ref = _jax_replica(corpus, queries, scfg)
    port = _port_replica(corpus, queries, StaticConfig(**scfg))
    n_search = 0
    for step, op in enumerate(ops):
        ref.apply(op)
        port.apply(op)
        if op[0] == "search":
            ctx = f"schedule {seed} step {step}"
            (ji, js, jt, jsb, jbl), (pi, ps, pt, psb, pbl) = ref.search(), port.search()
            np.testing.assert_array_equal(pi, ji, err_msg=ctx)
            np.testing.assert_array_equal(psb, jsb, err_msg=ctx)
            np.testing.assert_array_equal(pbl, jbl, err_msg=ctx)
            np.testing.assert_allclose(ps, js, **TOL, err_msg=ctx)
            np.testing.assert_allclose(pt, jt, **TOL, err_msg=ctx)
            n_search += 1
        assert port.live == ref.live
        assert port.adapter.pressure() == ref.adapter.pressure()
    assert n_search >= 3 and port.adapter.pressure()["generation"] >= 1


# ---- post-compaction parity within the port ------------------------------------------


def test_post_compaction_parity_vs_rebuild(mut_corpus):
    corpus, queries = mut_corpus
    rep = _port_replica(corpus, queries)
    for op in _schedule(np.random.default_rng(77), corpus.vocab, n_ops=8):
        rep.apply(op)
    rep.adapter.compact()

    ptr, tids, ws, ext_ids = rep.retr.index.logical_corpus()
    assert sorted(rep.live) == ext_ids.tolist()
    plain = Retriever.from_index(build_index(ptr, tids, ws, corpus.vocab, IndexBuildConfig(**BUILD), device=CPU),
                                 rep.retr.static_cfg, params=DynamicParams(k=K), device=CPU)
    mi_ids, mi_scores, mi_theta, mi_sb, mi_blk = rep.search()
    out = plain._backend(rep.qb, [DynamicParams(k=K)] * int(rep.qb.tids.shape[0]))
    p_ids = out.doc_ids.numpy()
    np.testing.assert_array_equal(mi_ids, np.where(p_ids >= 0, ext_ids[np.clip(p_ids, 0, None)], -1))
    np.testing.assert_array_equal(mi_scores, out.scores.numpy())
    np.testing.assert_array_equal(mi_theta, out.theta.numpy())
    np.testing.assert_array_equal(mi_sb, out.n_superblocks_visited.numpy())
    np.testing.assert_array_equal(mi_blk, out.n_blocks_scored.numpy())


# ---- freshness and tombstones ---------------------------------------------------------


def test_adds_visible_deletes_never_surface(mut_corpus):
    corpus, queries = mut_corpus
    rep = _port_replica(corpus, queries)
    qt, qw = queries[0]
    # a doc built from the query's own terms dominates: visible at once
    [doc_id], _ = rep.adapter.add_docs([(qt, np.full(qt.shape, 10.0, np.float32))])
    ids, scores, _, _, _ = rep.search()
    assert int(ids[0, 0]) == doc_id
    expected = float(np.float32(10.0) * np.sum(qw.astype(np.float32), dtype=np.float32))
    assert float(scores[0, 0]) == pytest.approx(expected, rel=1e-6)
    # deleted: gone from the next search, and after each of two compactions
    rep.adapter.delete_docs([doc_id])
    tops = sorted({int(i) for i in rep.search()[0][:, 0]} | {0, 7})  # every query's rank-0 doc now
    rep.adapter.delete_docs(tops)
    gone = {doc_id, *tops}
    for flip in range(3):
        ids = rep.search()[0]
        assert not (set(ids.ravel().tolist()) & gone), f"flip {flip}"
        rep.adapter.compact()
    with pytest.raises(KeyError):
        rep.adapter.delete_docs([doc_id])  # double delete
    with pytest.raises(KeyError):
        rep.adapter.delete_docs([10**9])  # never existed


def test_pressure_and_compaction_trigger(mut_corpus):
    corpus, queries = mut_corpus
    rep = _port_replica(corpus, queries)
    rng = np.random.default_rng(3)
    assert not rep.adapter.needs_compaction(2, 2)
    rep.adapter.add_docs([_rand_doc(rng, corpus.vocab) for _ in range(2)])
    assert rep.adapter.needs_compaction(2, 2)
    p = rep.adapter.pressure()
    assert p["delta_docs"] == 2 and p["tombstones"] == 0 and p["delta_seq"] == 1
    rep.adapter.delete_docs([3])
    assert rep.adapter.pressure()["tombstones"] == 1 and rep.adapter.needs_compaction(5, 1)
    rep.adapter.compact()
    p = rep.adapter.pressure()
    assert p["delta_docs"] == 0 and p["tombstones"] == 0 and p["generation"] == 1
    assert p["live_docs"] == CCFG.n_docs + 1 and not rep.adapter.needs_compaction(2, 2)


# ---- persistence through the facade ----------------------------------------------------


def test_mutable_store_roundtrip(mut_corpus, tmp_path):
    corpus, queries = mut_corpus
    rng = np.random.default_rng(5)
    rep = _port_replica(corpus, queries)
    rep.adapter.compact()  # generation 1
    rep.adapter.add_docs([_rand_doc(rng, corpus.vocab) for _ in range(3)])
    rep.adapter.delete_docs([rep.live[4]])
    before = rep.search()

    path = str(tmp_path / "mut")
    fp = rep.retr.save(path)
    loaded = Retriever.load(path, rep.retr.static_cfg, params=DynamicParams(k=K), device=CPU)
    out = loaded._backend(rep.qb, [DynamicParams(k=K)] * int(rep.qb.tids.shape[0]))
    after = (out.doc_ids, out.scores, out.theta, out.n_superblocks_visited, out.n_blocks_scored)
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)
    # mutation resumes where the save left off: monotonic ids, live tombstones
    assert loaded._adapter.pressure() == rep.adapter.pressure()
    assert loaded.add([_rand_doc(rng, corpus.vocab)])[0] == CCFG.n_docs + 3
    with pytest.raises(KeyError):
        loaded.delete([rep.live[4]])
    assert loaded.save(str(tmp_path / "mut2")) != fp  # another mutation point, another fingerprint


def test_a_loaded_single_index_promotes_from_its_forward_docs(mut_corpus, tmp_path):
    """Without its source corpus a retriever promotes from the dequantized
    forward index (corpus_from_index), and its compaction serves it."""
    corpus, queries = mut_corpus
    built = Retriever.build(corpus, build_cfg=IndexBuildConfig(**BUILD), params=DynamicParams(k=K), device=CPU)
    built.save(str(tmp_path / "single"))
    loaded = Retriever.load(str(tmp_path / "single"), built.static_cfg, params=DynamicParams(k=K), device=CPU)
    requests = [SearchRequest(t, w) for t, w in queries]
    want = built.search_batch(requests)
    loaded.mutable()
    ptr, tids, ws, ext_ids = loaded.index.logical_corpus()
    _assert_same_arrays((ptr, tids, ws), mutable.corpus_from_index(built.index))
    for a, b in zip(loaded.search_batch(requests), want):  # an empty delta passes through unchanged
        np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
        np.testing.assert_array_equal(a.scores, b.scores)
    loaded.compact()
    assert loaded.index.pressure()["generation"] == 1 and np.array_equal(ext_ids, np.arange(CCFG.n_docs))


# ---- refusals -------------------------------------------------------------------------


def test_a_sharded_retriever_is_neither_promoted_nor_saved(mut_corpus, tmp_path):
    corpus, _ = mut_corpus
    index = build_index(corpus.doc_ptr, corpus.tids, corpus.ws, corpus.vocab, IndexBuildConfig(**BUILD), device=CPU)
    scfg = StaticConfig(gamma=4, gamma0=2, k_max=K)
    retr = Retriever(lambda qb, dyn=None: None, index=shard_index(index, 2), static_cfg=scfg,
                     defaults=DynamicParams(k=K), backend_name="custom")
    with pytest.raises(ShardedPromotionError, match="save_sharded_index") as ei:
        retr.save(str(tmp_path / "never-written"))
    assert isinstance(ei.value, ValueError) and "save_sharded_index" in ei.value.workaround
    with pytest.raises(ShardedPromotionError, match="sharded") as ei:
        retr.add([(np.array([1, 2], np.int32), np.ones(2, np.float32))])
    assert "Retriever.load" in ei.value.workaround and "Retriever.build" in ei.value.workaround
    assert not (tmp_path / "never-written").exists()
    # a mutable index without a main generation (a sharded promotion) has nothing to save
    mi = mutable.MutableIndex.from_corpus(corpus.doc_ptr, corpus.tids, corpus.ws, corpus.vocab,
                                          IndexBuildConfig(**BUILD), build_main=False, device=CPU)
    with pytest.raises(ValueError, match="compact"):
        save_mutable_index(str(tmp_path / "mut"), mi)


# ---- the host pieces, byte for byte against JAX ---------------------------------------


def _assert_same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), (g, w)


def _csr(rng, n, vocab, empty_every=5):
    lens = rng.integers(1, 7, n)
    lens[::empty_every] = 0  # zero-length docs
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=ptr[1:])
    return ptr, rng.integers(0, vocab, ptr[-1]).astype(np.int64), rng.random(ptr[-1], dtype=np.float32)


def _plan(rng, tombstones, n_delta):
    m_ptr, m_tids, m_ws = _csr(rng, 40, 50)
    d_ptr, d_tids, d_ws = _csr(rng, n_delta, 50, empty_every=3)
    m_ext = np.cumsum(rng.integers(1, 4, 40)).astype(np.int64)  # ascending, with gaps
    d_ext = m_ext[-1] + 1 + np.arange(n_delta, dtype=np.int64)
    return dict(generation=0, delta_mark=n_delta, tombstones=frozenset(tombstones(m_ext, d_ext)), main_ptr=m_ptr,
                main_tids=m_tids, main_ws=m_ws, main_ext_ids=m_ext, delta_ptr=d_ptr, delta_tids=d_tids,
                delta_ws=d_ws, delta_ids=d_ext)


TOMBSTONES = {
    "none": lambda m, d: [],
    "scattered": lambda m, d: [int(m[3]), int(m[17]), int(m[20]), *map(int, d[1::2])],
    "all_main": lambda m, d: list(map(int, m)),
    "main_range_and_all_delta": lambda m, d: [*map(int, m[10:30]), *map(int, d)],
}


@pytest.mark.parametrize("n_delta", [0, 7])
@pytest.mark.parametrize("tombs", list(TOMBSTONES))
def test_live_csr_is_byte_equal_to_jax(tombs, n_delta):
    fields = _plan(np.random.default_rng(5), TOMBSTONES[tombs], n_delta)
    got = mutable._live_csr(mutable.CompactionPlan(**fields))
    want = jax_mutable._live_csr(jax_mutable.CompactionPlan(**fields))
    _assert_same_arrays(got, want)


@pytest.mark.parametrize("doc_bits", [8, 16])
def test_corpus_from_index_is_byte_equal_to_jax(doc_bits):
    rng = np.random.default_rng(11)
    ptr, tids, ws = _csr(rng, 150, 64)
    for d in range(150):  # distinct terms within a doc, as every corpus has them
        lo, hi = ptr[d], ptr[d + 1]
        tids[lo:hi] = rng.choice(64, hi - lo, replace=False)
    jax_idx = jax_build_index(ptr, tids, ws, 64, JaxIndexBuildConfig(b=4, c=8, kmeans_iters=1, doc_bits=doc_bits))
    got = mutable.corpus_from_index(from_arrays(jax_idx, CPU))
    _assert_same_arrays(got, jax_mutable.corpus_from_index(jax_idx))
    assert got[0][-1] == ptr[-1] and (np.diff(got[0]) == 0).sum() == (np.diff(ptr) == 0).sum()


def _merge_inputs(seed, n_delta):
    rng = np.random.default_rng(seed)
    q, km, k_max = 6, 7, 9
    main_scores = rng.integers(0, 4, (q, km)).astype(np.float32)  # coarse: many ties
    main_ids = rng.permutation(60)[: q * km].reshape(q, km).astype(np.int64)
    dead = rng.random((q, km)) < 0.2
    main_ids[dead], main_scores[dead] = -1, np.float32(-1e30)
    delta_ids = 100 + np.arange(n_delta, dtype=np.int64)
    delta_scores = rng.integers(0, 4, (q, n_delta)).astype(np.float32)
    if n_delta:
        delta_ids[n_delta // 2], delta_scores[:, n_delta // 2] = -1, np.float32(-1e30)  # a tombstoned delta doc
    k_rows = rng.integers(1, k_max + 1, q).astype(np.int64)
    theta = rng.random(q).astype(np.float32)
    return main_ids, main_scores, delta_ids, delta_scores, k_rows, k_max, theta


@pytest.mark.parametrize("n_delta", [0, 1, 5, 30])
def test_merge_mutable_topk_is_byte_equal_to_jax(n_delta):
    args = _merge_inputs(n_delta, n_delta)
    _assert_same_arrays(merge_mutable_topk(*args), jax_merge_mutable_topk(*args))


@pytest.mark.parametrize("n_delta", [0, 9])
def test_score_delta_docs_is_byte_equal_to_jax(n_delta):
    rng = np.random.default_rng(n_delta)
    vocab = 40
    q_tids = rng.integers(0, vocab + 1, (5, 12)).astype(np.int32)  # some sentinels, some repeats
    q_ws = np.where(q_tids == vocab, 0, rng.lognormal(0, 0.7, (5, 12))).astype(np.float32)
    d_tids = rng.integers(0, vocab + 1, (n_delta, 16)).astype(np.int32)
    d_ws = np.where(d_tids == vocab, 0, rng.random((n_delta, 16))).astype(np.float32)
    got = score_delta_docs(q_tids, q_ws, d_tids, d_ws, vocab)
    _assert_same_arrays([got], [jax_score_delta_docs(q_tids, q_ws, d_tids, d_ws, vocab)])


def test_out_of_range_query_ids_score_nothing_in_the_delta(mut_corpus):
    """The JAX package's score_delta_docs raises IndexError on a query id
    outside [-(vocab+1), vocab], and its mutable engine's worker stops on it.
    The port's wraps an id in [-(vocab+1), -1] once (as numpy does) and lets
    any other one add nothing (as its traversal does), so the same scores
    come out as for the query with those ids padded, and the mutable engine
    serves such a request and serves on."""
    rng = np.random.default_rng(4)
    vocab = 40
    q_tids = rng.integers(0, vocab, (3, 8)).astype(np.int32)
    q_ws = rng.random((3, 8), dtype=np.float32)
    d_tids = rng.integers(0, vocab + 1, (6, 8)).astype(np.int32)
    d_ws = rng.random((6, 8), dtype=np.float32)
    bad = q_tids.copy()
    bad[:, 0], bad[:, 1], bad[:, 2] = vocab + 3, -1, -(vocab + 5)
    with pytest.raises(IndexError):
        jax_score_delta_docs(bad, q_ws, d_tids, d_ws, vocab)
    padded = bad.copy()
    padded[:, [0, 2]] = vocab  # the sentinel: weight or not, it adds nothing
    got = score_delta_docs(bad, q_ws, d_tids, d_ws, vocab)
    _assert_same_arrays([got], [jax_score_delta_docs(padded, q_ws, d_tids, d_ws, vocab)])

    corpus, queries = mut_corpus
    retr = _port_replica(corpus, queries).retr
    retr.add([(np.array([1, 2, 3], np.int32), np.ones(3, np.float32))])
    engine = retr.serve(max_batch=4, compaction=False)
    try:
        qt, qw = queries[0]
        request = SearchRequest(np.concatenate([qt, [corpus.vocab + 3, -1, -(corpus.vocab + 5)]]),
                                np.concatenate([qw, [0.7, 0.9, 1.1]]))
        got = engine.search(request).result(timeout=60)
        np.testing.assert_array_equal(got.doc_ids, retr.search(request).doc_ids)
        after = engine.search(SearchRequest(qt, qw)).result(timeout=60)
        np.testing.assert_array_equal(after.doc_ids, retr.search(SearchRequest(qt, qw)).doc_ids)
        assert engine.stats.summary()["failures"] == 0
    finally:
        engine.shutdown()


# ---- the engine: concurrent mutation and search, background compaction ---------------


def test_engine_concurrent_mutation_zero_stale(mut_corpus):
    """A writer mutates while two readers search through the engine, with a
    CompactionManager flipping generations; every response is audited by its
    delta_seq: no deleted doc at or past its delete, no visible dominating
    doc missing."""
    corpus, queries = mut_corpus
    retr = Retriever.build(corpus, build_cfg=IndexBuildConfig(**BUILD), params=DynamicParams(k=K),
                           device=CPU).mutable()
    engine = retr.serve(max_batch=4, cache_size=64,
                        compaction=dict(max_delta_docs=6, max_tombstones=3, interval_s=0.05))
    qt, qw = queries[1]
    dominating = (qt, np.full(qt.shape, 50.0, np.float32))
    deleted_at, added_at = {}, {}
    stop = threading.Event()
    errors, responses = [], []

    def writer():
        rng = np.random.default_rng(13)
        try:
            for round_ in range(8):
                ids, seq = engine.add_docs([dominating, _rand_doc(rng, corpus.vocab)])
                added_at[ids[0]] = seq
                if round_ % 2 == 0:
                    deleted_at[ids[0]] = engine.delete_docs([ids[0]])
                stop.wait(0.03)
        except Exception as e:  # surfaced through errors
            errors.append(e)
        finally:
            stop.set()

    def reader():
        req = SearchRequest(qt, qw, params=DynamicParams(k=K))
        try:
            while not stop.is_set() and len(responses) < 200:
                responses.append(engine.search(req).result(timeout=60))
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=writer)] + [threading.Thread(target=reader) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and engine.stats.summary()["compactions"] < 1:
            stop.wait(0.05)
        responses.append(engine.search(SearchRequest(qt, qw, params=DynamicParams(k=K))).result(timeout=60))
        stale = lost = 0
        for r in responses:
            got = {int(i) for i in r.doc_ids if i >= 0}
            stale += sum(r.delta_seq >= seq and doc in got for doc, seq in deleted_at.items())
            live = [d for d, s in added_at.items()
                    if r.delta_seq >= s and (d not in deleted_at or r.delta_seq < deleted_at[d])]
            lost += bool(live) and not (set(live) & got)
        assert stale == 0 and lost == 0, (stale, lost)
        s = engine.stats.summary()
        assert s["compaction_failures"] == 0 and s["compactions"] >= 1 and s["last_compaction_ms"] > 0
        assert s["adds"] == 16 and s["deletes"] == 4 and s["overfetch_saturated"] >= 0
        assert s["delta_seq"] == retr._adapter.delta_seq()
    finally:
        stop.set()
        engine.shutdown()
    assert engine._compactor is None


def test_engine_mutation_surface(mut_corpus):
    """An immutable engine refuses mutations; the deprecated submit() shim
    answers (ids, scores) with a DeprecationWarning; ServeStats.percentile."""
    corpus, queries = mut_corpus
    retr = Retriever.build(corpus, build_cfg=IndexBuildConfig(**BUILD), params=DynamicParams(k=K), device=CPU)
    engine = retr.serve(max_batch=4)
    try:
        with pytest.raises(RuntimeError, match="mutable retriever"):
            engine.add_docs([(np.array([1], np.int32), np.ones(1, np.float32))])
        with pytest.raises(RuntimeError, match="mutable retriever"):
            engine.delete_docs([0])
        qt, qw = queries[2]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ids, scores = engine.submit(qt, qw).result(timeout=60)
        assert any(issubclass(w.category, DeprecationWarning) for w in caught)
        want = retr.search(SearchRequest(qt, qw))
        np.testing.assert_array_equal(ids, want.doc_ids)
        np.testing.assert_array_equal(scores, want.scores)
    finally:
        engine.shutdown()
    stats = ServeStats()
    assert stats.percentile(99) == 0.0
    for ms in (1.0, 2.0, 3.0, 4.0):
        stats.record(ms)
    assert stats.percentile(50) == 2.5 and stats.percentile(100) == 4.0
    assert {"adds", "deletes", "compactions", "compaction_failures", "last_compaction_ms",
            "overfetch_saturated"} <= stats.summary().keys()


def test_saturation_is_counted_when_tombstones_exceed_the_window(mut_corpus):
    """k_max == k: any tombstone clips the overfetch, and every clipped row
    (padding rows of the bucket too, as in the JAX package) is counted."""
    corpus, queries = mut_corpus
    retr = Retriever.build(corpus, StaticConfig(gamma=5, gamma0=2, k_max=K), build_cfg=IndexBuildConfig(**BUILD),
                           params=DynamicParams(k=K), device=CPU).mutable()
    engine = retr.serve(max_batch=4, cache_size=0, compaction=False)
    try:
        qt, qw = queries[0]
        first = engine.search(SearchRequest(qt, qw)).result(timeout=60)
        assert engine.stats.summary()["overfetch_saturated"] == 0
        engine.delete_docs([int(d) for d in first.doc_ids if d >= 0])
        engine.search(SearchRequest(qt, qw)).result(timeout=60)
        assert engine.stats.summary()["overfetch_saturated"] == 1  # one row: a batch-1 bucket
    finally:
        engine.shutdown()
