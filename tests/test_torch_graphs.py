"""The segmented traversal behind the CUDA graphs (``core.graphs``), run
eagerly with its buffer copies on the CPU, against ``search_retrieve``: ids,
scores, θ and both visit counters to the bit, at the width the set pads to.
The graphs themselves run only on a card (``chip_smoke.graphs_phase``); off
one, and under impl "ref" and "legacy", the runner is the eager traversal.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.config import DynamicParams, StaticConfig, dynamic_args
from repro_torch.core.graphs import GraphSet, graphs_engage, nq_bucket
from repro_torch.core.lsp import make_search_runner, search_retrieve
from repro_torch.core.query import QueryBatch, make_query_batch
from repro_torch.index.convert import from_arrays
from repro_torch.index.layout import _tensors

VARIANTS = {
    "lsp0": dict(variant="lsp0", gamma=8, gamma0=2),
    "lsp1": dict(variant="lsp1", gamma=8, gamma0=4),
    "lsp2": dict(variant="lsp2", gamma=8, gamma0=4),
    "sp": dict(variant="sp", gamma=16, gamma0=4),
    "bmp": dict(variant="bmp", gamma=16, gamma0=4),
}
# the raw launches each variant makes, in order (fwd layout; flat scores through doc_score_flat)
LAUNCHES = {
    "lsp0": ["sbmax", "doc_score", "boundsum_gather", "doc_score"],
    "lsp1": ["sbmax", "doc_score", "boundsum_gather", "doc_score"],
    "lsp2": ["sbmax", "doc_score", "sbmax", "boundsum_gather", "doc_score"],
    "sp": ["sbmax", "doc_score", "sbmax", "boundsum_gather", "doc_score"],
    "bmp": ["sbmax", "doc_score", "doc_score"],
}
POINT = DynamicParams(k=7, mu=0.5, eta=0.9, beta=0.6)
CASES = ([(v, layout, q, width, "uniform") for v in VARIANTS for layout in ("fwd", "flat") for q in (1, 7, 64)
          for width in ("exact", "padded")]
         + [(v, layout, 64, "padded", "mixed") for v in VARIANTS for layout in ("fwd", "flat")])


def _mixed_rows(q):
    return [DynamicParams(k=1 + (i * 3) % 10, mu=(0.2, 0.5, 0.9)[i % 3], eta=(0.7, 1.0)[i % 2],
                          beta=(0.33, 0.6, 1.0)[i % 3]) for i in range(q)]


@pytest.fixture(scope="module")
def port_index(tiny_index):
    return from_arrays(tiny_index, torch.device("cpu"))


def _batch(queries, q, vocab):
    """``q`` rows cycling through ``queries``, at the longest row's width (no
    padding)."""
    rows = [queries[i % len(queries)] for i in range(q)]
    return make_query_batch(rows, vocab, nq_max=max(len(t) for t, _ in rows), device="cpu")


def _pad(qb, width):
    pad = width - qb.tids.shape[1]
    return QueryBatch(torch.nn.functional.pad(qb.tids, (0, pad), value=qb.vocab),
                      torch.nn.functional.pad(qb.ws, (0, pad)), qb.vocab)


@pytest.mark.parametrize("variant,layout,q,width,rows", CASES)
def test_segmented_traversal_equals_search_retrieve(tiny_corpus, port_index, variant, layout, q, width, rows):
    _, _, queries = tiny_corpus
    vocab = port_index.vocab
    scfg = StaticConfig(**VARIANTS[variant], k_max=10, doc_layout=layout)
    qb = _batch(queries, q, vocab)
    nq = qb.tids.shape[1]
    # "exact": the batch fills the set's width; "padded": the set pads it with the sentinel
    set_nq = nq if width == "exact" else (nq_bucket(nq) if nq_bucket(nq) > nq else nq + 8)
    params = [POINT] * q if rows == "uniform" else _mixed_rows(q)
    want = search_retrieve(port_index, _pad(qb, set_nq), scfg, dynamic_args(params, q, scfg.k_max, "cpu"))

    constants = frozenset(t.untyped_storage().data_ptr() for t in _tensors(port_index))
    gs = GraphSet(lambda b, d: search_retrieve(port_index, b, scfg, d), q, set_nq, vocab, torch.device("cpu"),
                  constants)
    # batches of real terms in every slot, the first under other parameters, leave stale
    # data in every static buffer; the last batch keeps its parameters
    gen = torch.Generator().manual_seed(q)
    for stale_rows in (_mixed_rows(q)[::-1], params):
        gs.load(QueryBatch(torch.randint(0, vocab, (q, set_nq), generator=gen, dtype=torch.int32),
                           torch.rand((q, set_nq), generator=gen) + 0.1, vocab), stale_rows)
        gs.run_eager()
    gs.load(qb, params)
    got = gs.run_eager()

    for name in ("doc_ids", "scores", "theta", "n_superblocks_visited", "n_blocks_scored"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    kind = {"doc_score": f"doc_score_{layout}"}
    assert [s.name for s in gs.launches] == [f"{kind.get(n, n)}_ref" for n in LAUNCHES[variant]]
    assert (want.doc_ids >= 0).any()


@pytest.mark.parametrize("impl", ["auto", "ref", "legacy"])
def test_runner_off_cuda_is_the_eager_traversal(tiny_corpus, port_index, impl):
    _, _, queries = tiny_corpus
    scfg = StaticConfig(**VARIANTS["lsp1"], k_max=10)
    run = make_search_runner(port_index, scfg, impl=impl)
    qb = _batch(queries, 7, port_index.vocab)
    got = run(qb, _mixed_rows(7))
    want = search_retrieve(port_index, qb, scfg, _mixed_rows(7), impl=impl)
    for name in ("doc_ids", "scores", "theta", "n_superblocks_visited", "n_blocks_scored"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    run.warmup([(2, 16)])
    assert run.graph_stats() == {"captures": 0, "replays": 0, "eager": 2}
    assert run.n_traces() == 0


@pytest.mark.parametrize("impl,engaged", [("auto", True), ("kernel", True), ("ref", False), ("legacy", False)])
def test_graphs_engage_on_cuda_through_the_kernels(impl, engaged):
    assert graphs_engage(torch.device("cuda", 0), impl) is engaged
    assert not graphs_engage(torch.device("cpu"), impl)


def test_nq_bucket_is_make_query_batchs_padding():
    for nq in range(1, 70):
        qb = make_query_batch([(np.arange(nq), np.ones(nq))], 100, device="cpu")
        assert nq_bucket(nq) == qb.tids.shape[1]
