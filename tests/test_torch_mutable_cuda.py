"""The port's mutable index and shard cutter on the card: the mutable adapter
through the CUDA kernels against ``impl="ref"`` on the same mutable state, a
background compaction on the ``CompactionManager`` thread, a CUDA error
inside a compaction build, and ``shard_index`` on the card against its CPU
run.

Marked ``cuda``: they skip where there is no CUDA device. This file imports
neither JAX nor the JAX package, so it runs on a GPU machine without JAX:
``PYTHONPATH=src python -m pytest -q tests/test_torch_mutable_cuda.py``.
"""

import time
import types

import numpy as np
import pytest
import torch

from repro_torch.api import DynamicParams, Retriever, SearchRequest, StaticConfig
from repro_torch.core import ops
from repro_torch.data.synthetic import CorpusConfig, make_corpus, make_queries
from repro_torch.distributed.retrieval import shard_index
from repro_torch.index import mutable
from repro_torch.index.builder import IndexBuildConfig
from repro_torch.index.layout import index_device, index_to
from repro_torch.serve import MutableRetrieverAdapter

TOL = dict(rtol=1e-5, atol=1e-5)
K = 10
SCFG = StaticConfig(variant="lsp0", gamma=16, gamma0=4, k_max=64)  # k_max: room for tombstones
CCFG = CorpusConfig(n_docs=4096, vocab=1024, n_topics=8, seed=0)
BUILD = IndexBuildConfig(b=8, c=8, kmeans_iters=3)
KERNELS = ("sbmax_kernel", "boundsum_gather_kernel", "doc_score_fwd_kernel")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def data(cuda):
    corpus = make_corpus(CCFG)
    requests = [SearchRequest(t, w) for t, w in make_queries(CCFG, corpus, 32)]
    extra = make_corpus(CorpusConfig(n_docs=64, vocab=CCFG.vocab, n_topics=CCFG.n_topics, seed=2))
    docs = [(extra.tids[extra.doc_ptr[i]: extra.doc_ptr[i + 1]], extra.ws[extra.doc_ptr[i]: extra.doc_ptr[i + 1]])
            for i in range(64)]
    return corpus, requests, docs


def _promoted(corpus, device):
    return Retriever.build(corpus, SCFG, build_cfg=BUILD, params=DynamicParams(k=K), device=device).mutable()


def _ref_adapter(retr):
    """An adapter over the same mutable state whose main runtime is impl="ref"."""
    view = retr.index.state()
    ref_rt = Retriever.from_index(view.main, SCFG, impl="ref", params=DynamicParams(k=K), device=retr.device)._backend
    pinned = types.SimpleNamespace(state=lambda: view._replace(runtime=ref_rt), vocab=retr.vocab, device=retr.device)
    return MutableRetrieverAdapter(pinned, None)


def _search(backend, retr, requests):
    """``search_batch``'s responses through ``backend`` in place of the retriever's own."""
    own = retr._backend
    retr._backend = backend
    try:
        return retr.search_batch(requests)
    finally:
        retr._backend = own


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        assert (g.n_superblocks_visited, g.n_blocks_scored) == (w.n_superblocks_visited, w.n_blocks_scored)
        np.testing.assert_allclose(g.scores, w.scores, **TOL)
        np.testing.assert_allclose(g.theta, w.theta, **TOL)


@pytest.mark.cuda
def test_mutable_adapter_through_the_kernels_equals_ref(data, cuda):
    corpus, requests, docs = data
    retr = _promoted(corpus, cuda)
    added = retr.add(docs[:32])
    top = {int(i) for r in retr.search_batch(requests[:4]) for i in r.doc_ids[:3]}
    deleted = sorted(top)[:8] + added[:4]
    retr.delete(deleted)
    for stage in ("delta and tombstones", "compacted"):
        before = {k: getattr(ops, k).launches for k in KERNELS}
        got = retr.search_batch(requests)
        for name, n in before.items():
            assert getattr(ops, name).launches > n, f"{name} was not launched ({stage})"
        _assert_same(got, _search(_ref_adapter(retr), retr, requests))
        assert not {int(i) for r in got for i in r.doc_ids} & set(deleted), stage
        retr.compact()
    assert index_device(retr.index.state().main) == cuda


@pytest.mark.cuda
def test_background_compaction_serves_on_the_card(data, cuda):
    corpus, requests, docs = data
    retr = _promoted(corpus, cuda)
    engine = retr.serve(max_batch=8, nq_max=64, cache_size=0,
                        compaction=dict(max_delta_docs=8, max_tombstones=4, interval_s=0.05))
    try:
        ids, _ = engine.add_docs(docs[:8])
        deadline = time.monotonic() + 120
        while engine.stats.summary()["compactions"] < 1 and time.monotonic() < deadline:
            for r in requests[:8]:
                engine.search(r).result(timeout=120)
        s = engine.stats.summary()
        assert s["compactions"] >= 1 and s["compaction_failures"] == 0 and s["failures"] == 0
        view = retr.index.state()
        assert view.generation >= 1 and index_device(view.main) == cuda and view.runtime.device == cuda
        got = [engine.search(r).result(timeout=120) for r in requests]
        assert engine.epoch >= 1
        _assert_same(got, _search(_ref_adapter(retr), retr, requests))
    finally:
        engine.shutdown()


@pytest.mark.cuda
def test_a_cuda_error_in_a_compaction_build_is_counted_and_serving_goes_on(data, cuda, monkeypatch):
    corpus, requests, docs = data
    retr = _promoted(corpus, cuda)
    build = mutable.build_index

    def oom_build(*args, **kw):
        torch.empty(1 << 50, dtype=torch.uint8, device=kw["device"])  # a CUDA out-of-memory error
        return build(*args, **kw)

    monkeypatch.setattr(mutable, "build_index", oom_build)
    engine = retr.serve(max_batch=8, nq_max=64, cache_size=0,
                        compaction=dict(max_delta_docs=4, max_tombstones=64, interval_s=0.05))
    try:
        engine.add_docs(docs[:4])
        deadline = time.monotonic() + 60
        while engine.stats.summary()["compaction_failures"] < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        s = engine.stats.summary()
        assert s["compaction_failures"] >= 1 and s["compactions"] == 0
        got = [engine.search(r).result(timeout=120) for r in requests]
        _assert_same(got, retr.search_batch(requests))  # served from generation 0 + the delta
        assert engine.stats.summary()["failures"] == 0 and retr.index.state().generation == 0
    finally:
        engine.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [2, 3, 5])
def test_shard_index_on_the_card_equals_its_cpu_run(data, cuda, n_shards):
    corpus, _, _ = data
    idx = Retriever.build(corpus, SCFG, build_cfg=BUILD, device=cuda).index
    on_card = shard_index(idx, n_shards)
    on_cpu = shard_index(index_to(idx, "cpu"), n_shards)

    def leaves(x, path="shard"):
        if isinstance(x, torch.Tensor):
            yield path, x
        elif isinstance(x, tuple):
            for f in x._fields:
                yield from leaves(getattr(x, f), f"{path}.{f}")
        else:
            yield path, x

    for a, b in zip(on_card, on_cpu):
        assert index_device(a) == cuda
        for (path, x), (_, y) in zip(leaves(a), leaves(b)):
            if isinstance(y, torch.Tensor):
                assert x.dtype == y.dtype and x.cpu().numpy().tobytes() == y.numpy().tobytes(), path
            else:
                assert x == y, path
