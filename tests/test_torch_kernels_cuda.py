"""Each CUDA kernel of the port against its plain PyTorch version on the card.

Marked ``cuda``: they skip where there is no CUDA device. This file imports
neither JAX nor the JAX package, so it runs on a GPU machine without JAX:
``PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py``.
The input builders are shared with tests/test_torch_kernels.py, which holds
the same plain versions against the Pallas kernels on the CPU.
Tolerances rtol=1e-5, atol=1e-4: the sums run in float32 in another order.
"""

import numpy as np
import pytest
import torch

from repro_torch.index.pack import SEG_WORDS, pack_rows_strided
from repro_torch.kernels.boundsum_gather.ref import boundsum_gather_ref
from repro_torch.kernels.doc_score.ref import doc_score_fwd_ref
from repro_torch.kernels.sbmax.ref import sbmax_ref

TOL = dict(rtol=1e-5, atol=1e-4)

SBMAX_SHAPES = [(64, 1024, 2, 8), (300, 2048, 3, 17), (17, 3072, 1, 3)]
BOUNDSUM_GRID = [(4, 8), (4, 16), (4, 64), (8, 4), (8, 16)]
DOC_SCORE_SHAPES = [(32, 8, 16, 64, 2, 5), (17, 4, 24, 300, 3, 9), (8, 16, 8, 33, 1, 3)]


def _t(a: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _pack(mat: np.ndarray, bits: int, granule: int) -> np.ndarray:
    """int32 words (uint32 bits) of ``mat`` in the lane-strided layout."""
    return pack_rows_strided(torch.from_numpy(mat), bits, granule).numpy()


def _sbmax_inputs(bits, v, n, q, nq, granule=SEG_WORDS):
    vpw = 32 // bits
    n = -(-n // (vpw * granule)) * vpw * granule
    rng = np.random.default_rng(bits * 1000 + v)
    mat = rng.integers(0, 1 << bits, (v, n)).astype(np.uint8)
    tids = rng.integers(0, v, (q, nq)).astype(np.int32)
    ws = rng.random((q, nq)).astype(np.float32)
    ws[:, -1:] = 0.0  # a sentinel term: skipped by the kernels
    return _pack(mat, bits, granule), tids, ws


def _boundsum_inputs(bits, c):
    rng = np.random.default_rng(c)
    v, ns, q, nq, s = 150, 30, 2, 9, 7
    mat = rng.integers(0, 1 << bits, (v, ns * c)).astype(np.uint8)
    tids = rng.integers(0, v, (q, nq)).astype(np.int32)
    ws = rng.random((q, nq)).astype(np.float32)
    sel = rng.integers(0, ns, (q, s)).astype(np.int32)
    return _pack(mat, bits, c * bits // 32), tids, ws, sel


def _doc_score_inputs(nb, b, t, vocab, q, s, bits=8):
    rng = np.random.default_rng(nb * 10 + b)
    tids = rng.integers(0, vocab, (nb, b, t)).astype(np.int32)
    ws = rng.integers(0, 1 << bits, (nb, b, t)).astype(np.uint8 if bits == 8 else np.uint16)
    n_pad = rng.integers(0, t, (nb, b))  # padded slots: sentinel tid, zero weight
    for k in range(nb):
        for j in range(b):
            if n_pad[k, j]:
                tids[k, j, -n_pad[k, j]:] = vocab
                ws[k, j, -n_pad[k, j]:] = 0
    qdense = rng.standard_normal((q, vocab + 1)).astype(np.float32)
    qdense[:, vocab] = 0.0
    blk = rng.integers(0, nb, (q, s)).astype(np.int32)
    return tids, ws, qdense, blk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("granule", [SEG_WORDS, 2])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("v,n,q,nq", SBMAX_SHAPES)
def test_sbmax_cuda_matches_plain(cuda, bits, v, n, q, nq, granule):
    from repro_torch.kernels.sbmax.kernel import sbmax_kernel

    packed, tids, ws = (_t(a, cuda) for a in _sbmax_inputs(bits, v, n, q, nq, granule))
    got = sbmax_kernel(packed, tids, ws, bits, granule)
    want = sbmax_ref(packed, tids, ws, bits, granule)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,c", BOUNDSUM_GRID)
def test_boundsum_gather_cuda_matches_plain(cuda, bits, c):
    from repro_torch.kernels.boundsum_gather.kernel import boundsum_gather_kernel

    packed, tids, ws, sel = (_t(a, cuda) for a in _boundsum_inputs(bits, c))
    got = boundsum_gather_kernel(packed, c, bits, tids, ws, sel)
    want = boundsum_gather_ref(packed, c, bits, tids, ws, sel)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("nb,b,t,vocab,q,s", DOC_SCORE_SHAPES)
def test_doc_score_fwd_cuda_matches_plain(cuda, nb, b, t, vocab, q, s, bits):
    from repro_torch.kernels.doc_score.kernel import doc_score_fwd_kernel

    tids, ws, qdense, blk = (_t(a, cuda) for a in _doc_score_inputs(nb, b, t, vocab, q, s, bits))
    got = doc_score_fwd_kernel(tids, ws, qdense, blk)
    want = doc_score_fwd_ref(tids, ws, qdense, blk)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("doc_bits", [8, 16])
def test_search_kernel_path_matches_ref_path(cuda, doc_bits):
    """A small index built on the card, searched through impl="kernel" and
    impl="ref"; the exact backend returns k valid docs on every query."""
    from repro_torch.api import Retriever, SearchRequest, StaticConfig
    from repro_torch.data.synthetic import CorpusConfig, make_corpus, make_queries
    from repro_torch.index.builder import IndexBuildConfig

    ccfg = CorpusConfig(n_docs=8192, vocab=2048, n_topics=16, seed=0)
    corpus = make_corpus(ccfg)
    requests = [SearchRequest(t, w) for t, w in make_queries(ccfg, corpus, 32)]
    scfg = StaticConfig(gamma=16, gamma0=4)
    kern = Retriever.build(corpus, scfg, build_cfg=IndexBuildConfig(b=8, c=16, kmeans_iters=2, doc_bits=doc_bits),
                           impl="kernel", device=cuda)
    ref = Retriever.from_index(kern.index, scfg, impl="ref", device=cuda)
    for a, b in zip(kern.search_batch(requests), ref.search_batch(requests)):
        np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
        assert (a.n_superblocks_visited, a.n_blocks_scored) == (b.n_superblocks_visited, b.n_blocks_scored)
        np.testing.assert_allclose(a.scores, b.scores, rtol=1e-5, atol=1e-5)
    exact = Retriever.from_index(kern.index, scfg, backend="exact", device=cuda)
    assert all((r.doc_ids >= 0).all() for r in exact.search_batch(requests))
