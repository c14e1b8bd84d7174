"""Sharded serving on the card: the host-loop sharded retriever through the
CUDA kernels against ``impl="ref"`` and against the single-device kernel path
(ids, θ, both counters and the per-shard telemetry; each kernel launching once
per shard and round), a binding block budget, and ``swap_index`` of a shard
set on the card, from a directory and back to a single index.

Marked ``cuda``: they skip where there is no CUDA device. This file imports
neither JAX nor the JAX package, so it runs on a GPU machine without JAX:
``PYTHONPATH=src python -m pytest -q tests/test_torch_sharded_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.api import Retriever, SearchRequest, StaticConfig
from repro_torch.core import ops
from repro_torch.data.synthetic import CorpusConfig, make_corpus, make_queries
from repro_torch.distributed.sharded import ShardedRetriever
from repro_torch.index import store
from repro_torch.index.builder import IndexBuildConfig

TOL = dict(rtol=1e-5, atol=1e-5)
CCFG = CorpusConfig(n_docs=4096, vocab=1024, n_topics=8, seed=0)
BUILD = IndexBuildConfig(b=8, c=8, kmeans_iters=3)  # 64 superblocks: 3 shards of 22, one padded
N_SHARDS = 3
KERNELS = ("sbmax_kernel", "boundsum_gather_kernel", "doc_score_fwd_kernel")
CONFIGS = {
    "lsp0": StaticConfig(variant="lsp0", gamma=16, gamma0=4),
    "lsp2": StaticConfig(variant="lsp2", gamma=16, gamma0=4),
    "lsp0_block_budget": StaticConfig(variant="lsp0", gamma=32, gamma0=4, block_budget=48),
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def built(cuda):
    corpus = make_corpus(CCFG)
    requests = [SearchRequest(t, w) for t, w in make_queries(CCFG, corpus, 32)]
    local = Retriever.build(corpus, CONFIGS["lsp0"], build_cfg=BUILD, device=cuda)
    return local.index, requests


def _same(got, want, what, scores_equal=False):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids, err_msg=f"{what}, query {i}")
        assert (g.n_superblocks_visited, g.n_blocks_scored) == (w.n_superblocks_visited, w.n_blocks_scored), what
        if scores_equal:
            np.testing.assert_array_equal(g.scores, w.scores, err_msg=f"{what}, query {i}")
            assert g.theta == w.theta, what
        else:
            np.testing.assert_allclose(g.scores, w.scores, **TOL)
            np.testing.assert_allclose(g.theta, w.theta, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_kernel_path_equals_ref_and_the_single_device_kernels(built, cuda, name):
    idx, requests = built
    scfg = CONFIGS[name]
    sharded = Retriever.from_index(idx, scfg, shards=N_SHARDS, device=cuda)
    for attr in KERNELS:
        getattr(ops, attr).launches = 0
    got = sharded.search_batch(requests)
    launches = {attr: getattr(ops, attr).launches for attr in KERNELS}
    per_shard = {"sbmax_kernel": 2 if scfg.variant == "lsp2" else 1, "boundsum_gather_kernel": 1,
                 "doc_score_fwd_kernel": 2}
    assert launches == {attr: N_SHARDS * n for attr, n in per_shard.items()}, launches
    ref = Retriever.from_index(idx, scfg, shards=N_SHARDS, impl="ref", device=cuda).search_batch(requests)
    _same(got, ref, f"{name}: kernels vs impl='ref'")
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.shard_candidates, r.shard_candidates)
    local = Retriever.from_index(idx, scfg, device=cuda).search_batch(requests)
    _same(got, local, f"{name}: sharded vs local kernel path", scores_equal=True)


@pytest.mark.cuda
def test_swap_index_of_a_shard_set_on_the_card(built, cuda, tmp_path):
    idx, requests = built
    single, sharded_dir = str(tmp_path / "single"), str(tmp_path / "sharded")
    store.save_index(single, idx)
    store.save_sharded_index(sharded_dir, idx, N_SHARDS)
    retr = Retriever.load(sharded_dir, CONFIGS["lsp0"], device=cuda)
    assert retr.backend_name == "sharded" and retr._backend.device == cuda
    want = Retriever.from_index(idx, CONFIGS["lsp0"], device=cuda).search_batch(requests)
    engine = retr.serve(max_batch=8, nq_max=64, cache_size=0)
    try:
        engine.warmup()
        for epoch, target in ((1, single), (2, sharded_dir)):
            assert engine.swap_index(target) == epoch
            assert isinstance(engine.retriever, ShardedRetriever) and engine.retriever.n_shards == N_SHARDS
            got = [engine.search(r).result(timeout=120) for r in requests]
            assert all(g.epoch == epoch for g in got)
            _same(got, want, f"after swap {epoch}", scores_equal=True)
        assert engine.stats.summary()["failures"] == 0
    finally:
        engine.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [[], ["--shards", "3", "--swap-mid-run", "--sweep-k", "1,5,10"]],
                         ids=["single", "3-shard-host-loop"])
def test_the_serving_launchers_job_on_the_card_equals_impl_ref(cuda, extra, tmp_path, capsys):
    """``launch/serve.py``'s job through the kernels on the card: every
    response (and the k sweep's) equal to a pinned ``impl="ref"`` retriever
    over the index its epoch served (the swap rebuilds the index, and the
    k-means on the card uses atomics) on ids, θ and both counters."""
    from repro_torch.core.config import DynamicParams
    from repro_torch.launch.serve import parse_args, serve_job

    argv = ["--n-docs", "4096", "--vocab", "1024", "--requests", "32", "--max-batch", "8",
            "--index-dir", str(tmp_path / "index")] + extra
    run = serve_job(parse_args(argv))
    assert run.summary["failures"] == 0 and (not extra or run.recompiles == 0)
    refs = [Retriever.from_index(ix, run.static_cfg, params=run.params, impl="ref", device=cuda)
            for ix in (store.load_index_auto(str(tmp_path / "index"), device=cuda), run.swapped) if ix is not None]
    for i, ((t, w), resp) in enumerate(zip(run.queries, run.responses)):
        _same([resp], refs[resp.epoch].search_batch([SearchRequest(t, w)]), f"launcher, request {i}")
    if extra:
        assert {r.epoch for r in run.sweep} == {1}
        want = [r for k in (1, 5, 10) for r in refs[1].search_batch(
            [SearchRequest(t, w, params=DynamicParams(k=k, beta=run.params.beta)) for t, w in run.queries])]
        _same(run.sweep, want, "launcher sweep")
    assert "failures 0" in capsys.readouterr().out
