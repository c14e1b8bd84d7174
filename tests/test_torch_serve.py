"""The port's serving engine against the JAX package's, on the CPU.

The engine over the port's ``local`` backend answers as JAX's
``Retriever.search_batch`` does (ids, θ and both counters equal; scores and θ
within rtol=1e-5, atol=1e-5) and keeps the engine's failure semantics: batch
isolation, typed shutdown, deadlines, lanes, ladder degradation, cache
epochs, and ``swap_index`` from a directory JAX wrote. The pure parts
(bucket ladder, cache keys, degradation ladder, token bucket, SLO
controller) make the same decisions as JAX's on the same scripted clock.
"""

import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

import repro_torch.api as port_api
import repro_torch.serve as port_serve
import repro_torch.serve.engine as engine_mod
from repro.api import Retriever as JaxRetriever, SearchRequest as JaxSearchRequest
from repro.core.config import DynamicParams as JaxDynamicParams, StaticConfig as JaxStaticConfig
from repro.core.query import query_key as jax_query_key
from repro.index.store import save_index as jax_save_index
from repro.serve import BucketLadder as JaxBucketLadder, SLOConfig as JaxSLOConfig
from repro.serve import SLOController as JaxSLOController, TenantQuota as JaxTenantQuota
from repro.serve import TokenBucket as JaxTokenBucket, default_degradation_ladder as jax_default_ladder
from repro_torch.api import DynamicParams, Retriever, SearchRequest, StaticConfig
from repro_torch.core.config import DegradationRung
from repro_torch.core.query import query_key
from repro_torch.index.convert import from_arrays
from repro_torch.serve import (
    AdmissionConfig,
    BucketLadder,
    ChaosConfig,
    ChaosFault,
    ChaosInjector,
    DeadlineExceeded,
    EngineShutdown,
    QueryResultCache,
    RetrievalEngine,
    SLOConfig,
    SLOController,
    TenantQuota,
    TokenBucket,
    default_degradation_ladder,
)

TOL = dict(rtol=1e-5, atol=1e-5)
SCFG = dict(variant="lsp0", gamma=8, gamma0=2, k_max=10)
CPU = torch.device("cpu")

# The port's public surface: a change to either list is a change of its API.
API_SURFACE = [
    "ConfigError", "DynamicParams", "RetrievalConfig", "RetrievalEngine", "Retriever", "SearchRequest",
    "SearchResponse", "StaticConfig", "combine", "get_backend", "list_backends", "recommended",
    "recommended_static", "register_backend",
]
SERVE_SURFACE = [
    "AdmissionConfig", "AdmissionController", "AdmissionRejected", "Bucket", "BucketLadder", "ChaosConfig",
    "ChaosFault", "ChaosInjector", "ChaosRetriever", "CompactionManager", "DeadlineExceeded", "EngineShutdown",
    "MutableRetrievalResult", "MutableRetrieverAdapter", "QueryResultCache", "RetrievalEngine", "SLOConfig",
    "SLOController", "ServeError", "ServeStats", "TenantQuota", "TokenBucket", "default_degradation_ladder",
]


def test_public_surface_is_pinned():
    assert sorted(port_api.__all__) == API_SURFACE
    assert sorted(port_serve.__all__) == SERVE_SURFACE
    for module, names in ((port_api, API_SURFACE), (port_serve, SERVE_SURFACE)):
        assert all(getattr(module, n) is not None for n in names)
    assert port_api.RetrievalEngine is RetrievalEngine


# ---- echo retrievers on the CPU -------------------------------------------------------


def _echo(tag: float = 0.0, delay_ms: float = 0.0, dynamic: bool = True):
    """ids = first 4 canonical term ids, scores = their weights + ``tag``."""

    def retr(qb, dyn=None):
        if delay_ms:
            time.sleep(delay_ms / 1e3)
        return qb.tids[:, :4], qb.ws[:, :4] + tag

    retr.device = CPU
    if dynamic:
        retr.supports_dynamic = True
        retr.defaults = DynamicParams(k=4)
    return retr


def _gated(release, entered, seen=None):
    """A dynamic echo retriever that blocks inside the call until ``release``."""

    def retr(qb, dyn=None):
        if seen is not None:
            seen.extend(int(v) for v in qb.tids[:, 0])
        if not entered.is_set():
            entered.set()
            release.wait(timeout=30)
        return _echo()(qb)

    retr.device = CPU
    retr.supports_dynamic = True
    retr.defaults = DynamicParams(k=4)
    return retr


def _query(rng, n=6, vocab=512):
    return rng.choice(vocab, n, replace=False).astype(np.int32), rng.random(n).astype(np.float32) + 0.1


# ---- against JAX on the tiny index ------------------------------------------------------


@pytest.fixture(scope="module")
def port_retriever(tiny_index):
    return Retriever.from_index(from_arrays(tiny_index, CPU), StaticConfig(**SCFG), device=CPU)


@pytest.fixture(scope="module")
def jax_responses(tiny_index, tiny_corpus):
    _, _, queries = tiny_corpus
    return JaxRetriever.from_index(tiny_index, JaxStaticConfig(**SCFG)).search_batch(
        [JaxSearchRequest(t, w) for t, w in queries])


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        assert (g.n_superblocks_visited, g.n_blocks_scored) == (w.n_superblocks_visited, w.n_blocks_scored)
        np.testing.assert_allclose(g.scores, w.scores, **TOL)
        np.testing.assert_allclose(g.theta, w.theta, **TOL)


@pytest.mark.parametrize("max_batch", [1, 4, 16])
def test_engine_matches_jax_search_batch(port_retriever, jax_responses, tiny_corpus, max_batch):
    _, _, queries = tiny_corpus
    engine = port_retriever.serve(max_batch=max_batch, nq_max=64, cache_size=0, warmup=True)
    try:
        got = [f.result(timeout=60) for f in [engine.search(SearchRequest(t, w)) for t, w in queries]]
    finally:
        engine.shutdown()
    _assert_same(got, jax_responses)
    assert all(r.epoch == 0 and not r.cache_hit and r.bucket[0] <= max_batch for r in got)


def test_bucketed_results_equal_padded_bit_for_bit(port_retriever, tiny_corpus):
    _, _, queries = tiny_corpus
    padded = port_retriever.serve(max_batch=4, nq_max=64, batch_buckets=[4], nq_buckets=[64], cache_size=0)
    bucketed = port_retriever.serve(max_batch=4, nq_max=64, cache_size=0)
    try:
        for t, w in queries[:6]:
            a = padded.search(SearchRequest(t, w)).result(timeout=60)
            b = bucketed.search(SearchRequest(t, w)).result(timeout=60)
            np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
            np.testing.assert_array_equal(a.scores, b.scores)
            assert a.bucket == (4, 64) and b.bucket[0] == 1
    finally:
        padded.shutdown()
        bucketed.shutdown()


def test_swap_index_from_a_directory_jax_wrote(port_retriever, jax_responses, tiny_index, tiny_corpus, tmp_path):
    _, _, queries = tiny_corpus
    jax_save_index(str(tmp_path / "index"), tiny_index)
    engine = port_retriever.serve(max_batch=4, nq_max=64, cache_size=32)
    try:
        before = [engine.search(SearchRequest(t, w)).result(timeout=60) for t, w in queries]
        assert engine.search(SearchRequest(*queries[0])).result(timeout=60).cache_hit
        assert engine.swap_index(str(tmp_path / "index")) == 1
        after = [engine.search(SearchRequest(t, w)).result(timeout=60) for t, w in queries]
        assert all(r.epoch == 1 and not r.cache_hit for r in after)
        _assert_same(after, before)
        _assert_same(after, jax_responses)
        assert engine.stats.summary()["swaps"] == 1
    finally:
        engine.shutdown()


# ---- cache ------------------------------------------------------------------------------


def test_cache_hit_eviction_and_no_aliasing():
    calls = []

    def counting(qb, dyn=None):
        calls.append(qb.tids.shape[0])
        return _echo()(qb)

    counting.device, counting.supports_dynamic, counting.defaults = CPU, True, DynamicParams(k=4)
    engine = RetrievalEngine(counting, vocab=512, max_batch=1, nq_max=16, cache_size=2)
    try:
        rng = np.random.default_rng(1)
        q1, q2, q3 = (_query(rng) for _ in range(3))
        r1 = engine.search(SearchRequest(*q1)).result(timeout=30)
        n = len(calls)
        perm = np.argsort(q1[0])
        hit = engine.search(SearchRequest(q1[0][perm], q1[1][perm])).result(timeout=30)  # canonical key
        assert hit.cache_hit and len(calls) == n
        np.testing.assert_array_equal(hit.doc_ids, r1.doc_ids)
        expected = hit.doc_ids.copy()
        hit.doc_ids[:] = -1  # a caller mutating its response must not poison the cache
        r1.scores[:] = -1.0
        again = engine.search(SearchRequest(*q1)).result(timeout=30)
        np.testing.assert_array_equal(again.doc_ids, expected)
        assert (again.scores > 0).all()
        engine.search(SearchRequest(*q2)).result(timeout=30)
        engine.search(SearchRequest(*q3)).result(timeout=30)  # capacity 2: q1 evicted
        before = len(calls)
        engine.search(SearchRequest(*q1)).result(timeout=30)
        assert len(calls) == before + 1
        s = engine.stats.summary()
        assert s["cache_hits"] == 2 and s["cache_misses"] == 4 and engine.cache.evictions >= 1
        # a distinct dynamic point is a distinct entry
        other = engine.search(SearchRequest(*q1, params=DynamicParams(k=3))).result(timeout=30)
        assert not other.cache_hit and other.k == 3
    finally:
        engine.shutdown()
    c = QueryResultCache(capacity=2)
    c.put(b"a", 1)
    c.put(b"b", 2)
    assert c.get(b"a") == 1
    c.put(b"c", 3)
    assert c.get(b"b") is None and c.evictions == 1 and len(c) == 2


# ---- failure semantics -----------------------------------------------------------------


def test_retriever_runtime_error_fails_only_its_batch():
    class Boom(RuntimeError):
        pass

    def flaky(qb, dyn=None):
        if (qb.tids[:, 0] == 13).any():
            raise Boom("injected")
        return _echo()(qb)

    flaky.device, flaky.supports_dynamic, flaky.defaults = CPU, True, DynamicParams(k=4)
    engine = RetrievalEngine(flaky, vocab=512, max_batch=2, nq_max=16, cache_size=0)
    try:
        with pytest.raises(Boom):
            engine.search(SearchRequest(np.array([13], np.int32), np.array([9.0], np.float32))).result(timeout=30)
        good = engine.search(SearchRequest(np.array([7, 3], np.int32), np.array([2.0, 1.0], np.float32)))
        r = good.result(timeout=30)
        assert r.doc_ids[0] == 7 and r.scores[0] == 2.0
        s = engine.stats.summary()
        assert s["failures"] == 1 and s["requests"] == 1
    finally:
        engine.shutdown()


def test_shutdown_drains_with_typed_engine_shutdown():
    entered, release = threading.Event(), threading.Event()
    engine = RetrievalEngine(_gated(release, entered), vocab=512, max_batch=1, nq_max=16, max_wait_ms=0.0,
                             cache_size=0)
    rng = np.random.default_rng(4)
    try:
        blocker = engine.search(SearchRequest(*_query(rng)))
        assert entered.wait(timeout=30)
        queued = engine.search(SearchRequest(*_query(rng), request_id="q-late"))
        shut = threading.Thread(target=engine.shutdown)
        shut.start()
        time.sleep(0.05)
        release.set()
        shut.join(timeout=30)
        assert not shut.is_alive()
        blocker.result(timeout=30)  # the in-flight batch completes
        exc = queued.exception(timeout=30)
        assert isinstance(exc, EngineShutdown) and isinstance(exc, RuntimeError) and exc.request_id == "q-late"
        with pytest.raises(EngineShutdown) as ei:
            engine.search(SearchRequest(*_query(rng), request_id="post-stop"))
        assert ei.value.request_id == "post-stop" and engine.stats.summary()["rejected"] >= 2
        with pytest.raises(EngineShutdown):
            engine.swap_retriever(_echo())
    finally:
        release.set()
        engine.shutdown()


def test_deadline_expires_in_the_queue_and_is_never_scored():
    entered, release, seen = threading.Event(), threading.Event(), []
    engine = RetrievalEngine(_gated(release, entered, seen), vocab=512, max_batch=1, nq_max=16, max_wait_ms=0.0,
                             cache_size=0)
    try:
        rng = np.random.default_rng(2)
        blocker = engine.search(SearchRequest(*_query(rng)))
        assert entered.wait(timeout=30)
        doomed = engine.search(SearchRequest(np.array([13], np.int32), np.array([1.0], np.float32),
                                             deadline_ms=30.0, request_id="doomed-1"))
        time.sleep(0.08)
        release.set()
        blocker.result(timeout=30)
        with pytest.raises(DeadlineExceeded) as ei:
            doomed.result(timeout=30)
        assert ei.value.request_id == "doomed-1" and isinstance(ei.value, TimeoutError)
        assert 13 not in seen
        s = engine.stats.summary()
        assert s["deadline_expired"] == 1 and s["requests"] == 1 and len(engine.stats.latencies_ms) == 1
    finally:
        release.set()
        engine.shutdown()


def test_interactive_lane_preempts_the_batch_lane():
    entered, release, order = threading.Event(), threading.Event(), []
    engine = RetrievalEngine(_gated(release, entered, order), vocab=512, max_batch=1, nq_max=16, max_wait_ms=0.0,
                             cache_size=0)
    try:
        q = lambda tid, **kw: SearchRequest(np.array([tid], np.int32), np.array([1.0], np.float32), **kw)
        futs = [engine.search(q(1))]
        assert entered.wait(timeout=30)
        futs += [engine.search(q(100 + i)) for i in range(2)]
        futs += [engine.search(q(200 + i, priority="batch")) for i in range(2)]
        futs += [engine.search(q(300))]
        release.set()
        for f in futs:
            f.result(timeout=30)
        served = [t for t in order if t != 1]
        assert max(served.index(t) for t in (100, 101, 300)) < min(served.index(t) for t in (200, 201)), served
    finally:
        release.set()
        engine.shutdown()


def test_degraded_nq_cap_rides_a_smaller_bucket_under_its_own_cache_key():
    ladder = [DegradationRung(DynamicParams(k=4)), DegradationRung(DynamicParams(k=4, mu=0.3), nq_cap=16)]
    slo = SLOConfig(p99_ms=10_000.0, queue_high=0.01, interval_ms=0.0, recover_after=10_000, ladder=ladder)
    entered, release = threading.Event(), threading.Event()
    engine = RetrievalEngine(_gated(release, entered), vocab=512, max_batch=1, nq_max=64, max_wait_ms=0.0,
                             cache_size=32, slo=slo)
    try:
        rng = np.random.default_rng(6)
        q = _query(rng, n=24)
        blocker = engine.search(SearchRequest(*_query(rng)))
        assert entered.wait(timeout=30)
        probe1 = engine.search(SearchRequest(*_query(rng)))
        probe2 = engine.search(SearchRequest(*q))
        release.set()
        for f in (blocker, probe1, probe2):
            f.result(timeout=30)
        r = probe2.result()
        assert r.degraded and r.bucket[1] == 16 and r.params_served == r.params and r.params.mu == 0.3
        engine.slo._state.level = 0
        r2 = engine.search(SearchRequest(*q)).result(timeout=30)
        assert not r2.cache_hit and not r2.degraded and r2.bucket[1] == 64
    finally:
        release.set()
        engine.shutdown()


def test_every_future_resolves_once_under_chaos_and_swap():
    double_sets = []
    orig_r, orig_e = engine_mod._try_set_result, engine_mod._try_set_exception

    def wr(fut, v):
        if fut.done():
            double_sets.append("result")
        orig_r(fut, v)

    def we(fut, e):
        if fut.done():
            double_sets.append("exc")
        orig_e(fut, e)

    engine_mod._try_set_result, engine_mod._try_set_exception = wr, we
    engine = RetrievalEngine(_echo(delay_ms=1.0), vocab=512, max_batch=4, nq_max=16, max_wait_ms=0.2,
                             cache_size=16, queue_depth=8,
                             chaos=ChaosInjector(ChaosConfig(fault_every=3, spike_every=2, spike_ms=3.0, seed=7)),
                             admission=AdmissionConfig(default_deadline_ms=5_000.0))
    futs, raised, resolved = [], [], Counter()
    post_swap, lock = threading.Event(), threading.Lock()
    try:
        rng = np.random.default_rng(7)
        pool = [_query(rng) for _ in range(6)]

        def client(seed):
            crng = np.random.default_rng(seed)
            for _ in range(10):
                t, w = pool[int(crng.integers(0, len(pool)))]
                try:
                    f = engine.search(SearchRequest(t, w, deadline_ms=1.0 if crng.random() < 0.2 else None,
                                                    priority="batch" if crng.random() < 0.3 else "interactive"))
                except EngineShutdown:
                    with lock:
                        raised.append("shutdown")
                    return
                f.add_done_callback(lambda fu: resolved.update([id(fu)]))
                with lock:
                    futs.append((f, post_swap.is_set()))

        threads = [threading.Thread(target=client, args=(s,)) for s in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.02)
        engine.swap_retriever(_echo(tag=100.0, delay_ms=1.0), warm=False)
        post_swap.set()
        time.sleep(0.02)
        engine.shutdown()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        engine.shutdown()
        engine_mod._try_set_result, engine_mod._try_set_exception = orig_r, orig_e
    assert not double_sets
    kinds = Counter()
    for f, was_post_swap in futs:
        assert f.done()
        exc = f.exception(timeout=1)
        if exc is None:
            kinds["served"] += 1
            r = f.result()
            if was_post_swap and not r.cache_hit:
                assert r.epoch == 1 and float(r.scores[0]) > 50.0
        else:
            assert isinstance(exc, (ChaosFault, DeadlineExceeded, EngineShutdown)), exc
            kinds[type(exc).__name__] += 1
    assert len(resolved) == len(futs) and all(v == 1 for v in resolved.values())
    s = engine.stats.summary()
    assert s["requests"] == kinds["served"] and s["failures"] == kinds.get("ChaosFault", 0)
    assert s["deadline_expired"] == kinds.get("DeadlineExceeded", 0)
    assert s["rejected"] == kinds.get("EngineShutdown", 0) + len(raised)
    assert s["delta_docs"] == s["tombstones"] == s["delta_seq"] == 0


# ---- pure parts against JAX on scripted inputs -----------------------------------------------


@pytest.mark.parametrize("args", [(32, 64, None, None), (64, 64, None, None), (8, 32, [64, 2, 2], [32]),
                                  (1, 200, None, [8, 100])])
def test_bucket_ladder_matches_jax(args):
    port, jax_lad = BucketLadder(*args), JaxBucketLadder(*args)
    assert (port.batch_sizes, port.nq_sizes) == (jax_lad.batch_sizes, jax_lad.nq_sizes)
    for n in range(0, 80, 3):
        for nq in range(0, 260, 7):
            a, b = port.select(n, nq), jax_lad.select(n, nq)
            assert (a.batch, a.nq) == (b.batch, b.nq)
    assert [(b.batch, b.nq) for b in port.shapes()] == [(b.batch, b.nq) for b in jax_lad.shapes()]


def test_query_key_and_key_bytes_match_jax():
    rng = np.random.default_rng(0)
    for i in range(20):
        t = rng.integers(-5, 600, rng.integers(0, 30)).astype(np.int32)
        w = rng.choice([0.5, 1.0, 2.0], len(t)).astype(np.float32)  # ties in weight
        for nq in (0, 3, 16):
            assert query_key(t, w, nq) == jax_query_key(t, w, nq)
    for kw in (dict(), dict(k=7, mu=0.3, eta=0.9, beta=1.0), dict(k=100, mu=1e-3, eta=2.5, beta=0.01)):
        assert DynamicParams(**kw).key_bytes() == JaxDynamicParams(**kw).key_bytes()


@pytest.mark.parametrize("k,nq_max", [(10, 64), (100, 256), (1, 16)])
def test_default_degradation_ladder_matches_jax(k, nq_max):
    port = default_degradation_ladder(DynamicParams(k=k), nq_max)
    want = jax_default_ladder(JaxDynamicParams(k=k), nq_max)
    assert [(r.params.k, r.params.mu, r.params.eta, r.params.beta, r.nq_cap) for r in port] == \
        [(r.params.k, r.params.mu, r.params.eta, r.params.beta, r.nq_cap) for r in want]


def test_token_bucket_matches_jax_on_a_scripted_clock():
    now = [0.0]
    port = TokenBucket(TenantQuota(rate=10.0, burst=3.0), clock=lambda: now[0])
    jax_b = JaxTokenBucket(JaxTenantQuota(rate=10.0, burst=3.0), clock=lambda: now[0])
    rng = np.random.default_rng(3)
    for _ in range(200):
        now[0] += float(rng.choice([0.0, 0.01, 0.05, 0.3]))
        assert port.try_acquire() == jax_b.try_acquire()
        assert port.tokens == pytest.approx(jax_b.tokens)


def test_slo_controller_matches_jax_on_a_scripted_clock():
    now = [0.0]
    kw = dict(p99_ms=50.0, interval_ms=10.0, recover_after=3, queue_high=0.5, recover_margin=0.8)
    port = SLOController(SLOConfig(**kw), queue_capacity=10, defaults=DynamicParams(k=10), nq_max=64,
                         clock=lambda: now[0])
    jax_c = JaxSLOController(JaxSLOConfig(**kw), queue_capacity=10, defaults=JaxDynamicParams(k=10), nq_max=64,
                             clock=lambda: now[0])
    rng = np.random.default_rng(4)
    levels = []
    for step in range(300):
        now[0] += float(rng.choice([0.004, 0.012, 0.03]))
        lat = float(rng.choice([5.0, 20.0, 200.0], p=[0.6, 0.3, 0.1]) if step < 150 else 5.0)
        port.record(lat)
        jax_c.record(lat)
        depth = int(rng.integers(0, 10)) if step < 150 else 0
        a, b = port.observe(depth), jax_c.observe(depth)
        assert a == b
        levels.append(a)
        pe, pd, pc = port.resolve(None, DynamicParams(k=10))
        je, jd, jc = jax_c.resolve(None, JaxDynamicParams(k=10))
        assert (pd, pc) == (jd, jc) and (pe is None) == (je is None)
        if pe is not None:
            assert (pe.k, pe.mu, pe.eta, pe.beta) == (je.k, je.mu, je.eta, je.beta)
    assert max(levels) == len(port.ladder) - 1 and levels[-1] == 0  # went through every level and back
    assert port.snapshot() == jax_c.snapshot()


def test_chaos_retriever_forwards_the_runner_contract_and_injects(port_retriever, tiny_corpus):
    _, _, queries = tiny_corpus
    inner = port_retriever._backend
    chaotic = port_serve.ChaosRetriever(inner, ChaosConfig(fault_every=2))
    assert chaotic.supports_dynamic and chaotic.defaults == inner.defaults and chaotic.device == CPU
    engine = RetrievalEngine(chaotic, port_retriever.vocab, max_batch=1, nq_max=64, cache_size=0)
    try:
        first = engine.search(SearchRequest(*queries[0])).result(timeout=60)  # batch 1: clean
        with pytest.raises(ChaosFault):
            engine.search(SearchRequest(*queries[0])).result(timeout=60)  # batch 2: injected
        again = engine.search(SearchRequest(*queries[0])).result(timeout=60)
        np.testing.assert_array_equal(again.doc_ids, first.doc_ids)
        assert chaotic.injector.summary()["faults_injected"] == 1
    finally:
        engine.shutdown()


def test_tenant_quota_rejects_typed_and_isolates_tenants():
    adm = AdmissionConfig(quotas={"a": TenantQuota(rate=1e-3, burst=2.0)},
                          default_quota=TenantQuota(rate=1e-3, burst=1.0))
    engine = RetrievalEngine(_echo(), vocab=512, max_batch=2, nq_max=16, cache_size=0, admission=adm)
    try:
        rng = np.random.default_rng(0)
        for _ in range(2):
            engine.search(SearchRequest(*_query(rng), tenant="a")).result(timeout=30)
        with pytest.raises(port_serve.AdmissionRejected) as ei:
            engine.search(SearchRequest(*_query(rng), tenant="a", request_id="rq-a3"))
        assert ei.value.tenant == "a" and ei.value.request_id == "rq-a3"
        engine.search(SearchRequest(*_query(rng), tenant="x")).result(timeout=30)  # the default quota
        with pytest.raises(port_serve.AdmissionRejected):
            engine.search(SearchRequest(*_query(rng), tenant="x"))
        engine.search(SearchRequest(*_query(rng), tenant="y")).result(timeout=30)  # a bucket of its own
        s = engine.stats.summary()
        assert s["quota_rejected"] == 2 and s["requests"] == 4 and s["failures"] == 0
    finally:
        engine.shutdown()
