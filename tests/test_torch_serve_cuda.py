"""The port's serving engine on the card: the CUDA kernels behind
``Retriever.serve``, against ``search_batch`` on the same retriever.

Marked ``cuda``: they skip where there is no CUDA device. This file imports
neither JAX nor the JAX package, so it runs on a GPU machine without JAX:
``PYTHONPATH=src python -m pytest -q tests/test_torch_serve_cuda.py``.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.api import Retriever, SearchRequest, StaticConfig
from repro_torch.core import ops
from repro_torch.data.synthetic import CorpusConfig, make_corpus, make_queries
from repro_torch.index.builder import IndexBuildConfig
from repro_torch.serve import ChaosConfig, ChaosFault, ChaosInjector, RetrievalEngine

TOL = dict(rtol=1e-5, atol=1e-5)  # the same kernels on batches of another shape
SCFG = StaticConfig(variant="lsp0", gamma=16, gamma0=4, k_max=10)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def served(cuda):
    """A retriever over a 4,096-document index built on the card, 32 requests
    and their ``search_batch`` responses."""
    cfg = CorpusConfig(n_docs=4096, vocab=1024, n_topics=8, seed=0)
    corpus = make_corpus(cfg)
    retr = Retriever.build(corpus, SCFG, build_cfg=IndexBuildConfig(b=8, c=8, kmeans_iters=3), device=cuda)
    requests = [SearchRequest(t, w) for t, w in make_queries(cfg, corpus, 32)]
    return retr, requests, retr.search_batch(requests)


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        assert (g.n_superblocks_visited, g.n_blocks_scored) == (w.n_superblocks_visited, w.n_blocks_scored)
        np.testing.assert_allclose(g.scores, w.scores, **TOL)
        np.testing.assert_allclose(g.theta, w.theta, **TOL)


def _serve_all(engine, requests, n_threads=4):
    out = [None] * len(requests)

    def client(first):
        for i in range(first, len(requests), n_threads):
            out[i] = engine.search(requests[i]).result(timeout=120)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    return out


@pytest.mark.cuda
def test_engine_matches_search_batch_through_the_kernels(served):
    retr, requests, want = served
    assert retr.device.type == "cuda"
    before = {k: getattr(ops, k).launches for k in ("sbmax_kernel", "boundsum_gather_kernel", "doc_score_fwd_kernel")}
    engine = retr.serve(max_batch=8, nq_max=64, cache_size=0, warmup=True)
    try:
        _assert_same(_serve_all(engine, requests), want)
    finally:
        engine.shutdown()
    for name, n in before.items():
        assert getattr(ops, name).launches > n, f"{name} was not launched"


@pytest.mark.cuda
def test_out_of_range_term_ids_are_served_and_the_engine_serves_on(served):
    retr, requests, want = served
    vocab = retr.vocab
    bad = [SearchRequest(np.concatenate([r.tids, [vocab + 3, -1, -(vocab + 5)]]),
                         np.concatenate([r.weights, [0.5, 1.5, 2.5]])) for r in requests[:8]]
    ref = Retriever.from_index(retr.index, SCFG, impl="ref", device=retr.device)
    engine = retr.serve(max_batch=8, nq_max=64, cache_size=0)
    try:
        _assert_same(_serve_all(engine, bad), ref.search_batch(bad))
        _assert_same(_serve_all(engine, requests), want)  # the next batches still run
        torch.cuda.synchronize()
    finally:
        engine.shutdown()


@pytest.mark.cuda
def test_chaos_fails_only_its_batches_on_the_card(served):
    retr, requests, want = served
    engine = retr.serve(max_batch=4, nq_max=64, cache_size=0,
                        chaos=ChaosInjector(ChaosConfig(fault_every=2)))
    try:
        futs = [engine.search(r) for r in requests]
        excs = [f.exception(timeout=120) for f in futs]
        assert all(e is None or isinstance(e, ChaosFault) for e in excs)
        assert sum(e is not None for e in excs) == engine.stats.summary()["failures"] > 0
        _assert_same([f.result() for f, e in zip(futs, excs) if e is None],
                     [w for w, e in zip(want, excs) if e is None])
    finally:
        engine.shutdown()


@pytest.mark.cuda
def test_swap_index_from_a_saved_directory_on_the_card(served, tmp_path):
    retr, requests, want = served
    fp = retr.save(str(tmp_path / "index"))
    loaded = Retriever.load(str(tmp_path / "index"), SCFG, device=retr.device)
    assert loaded.device == retr.device
    _assert_same(loaded.search_batch(requests), want)
    engine = retr.serve(max_batch=8, nq_max=64, cache_size=64)
    try:
        assert engine.swap_index(str(tmp_path / "index")) == 1
        got = _serve_all(engine, requests)
        assert all(r.epoch == 1 and not r.cache_hit for r in got)
        _assert_same(got, want)
    finally:
        engine.shutdown()
    assert len(fp) == 32


@pytest.mark.cuda
def test_kernel_launch_and_cuda_errors_fail_only_their_batch(served):
    """A kernel wrapper's launch error and a CUDA out-of-memory error are
    RuntimeErrors, so the engine fails the batch that met them and serves on."""
    from repro_torch.kernels import _build

    retr, requests, want = served
    backend = retr._backend

    def faulty(qb, dyn=None):
        first = int(qb.tids[0, 0])
        if first == -7:  # the C entry refuses bits=5 before launching anything
            _build.check_launch("sbmax", _build.load("sbmax")(0, 0, 0, 0, 1, 1, 4, 1, 5, None))
        if first == -8:
            torch.empty(1 << 50, dtype=torch.uint8, device=qb.tids.device)
        return backend(qb, dyn)

    faulty.device, faulty.supports_dynamic, faulty.defaults = retr.device, True, retr.defaults
    engine = RetrievalEngine(faulty, retr.vocab, max_batch=1, nq_max=64, cache_size=0)
    try:
        marker = lambda tid: SearchRequest(np.array([tid], np.int32), np.array([1.0], np.float32))
        with pytest.raises(RuntimeError, match="cudaError_t"):
            engine.search(marker(-7)).result(timeout=120)
        with pytest.raises(torch.OutOfMemoryError):
            engine.search(marker(-8)).result(timeout=120)
        _assert_same(_serve_all(engine, requests), want)
        assert engine.stats.summary()["failures"] == 2
    finally:
        engine.shutdown()
