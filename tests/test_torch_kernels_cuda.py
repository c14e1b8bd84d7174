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
from repro_torch.kernels.dequant_matmul.ref import dequant_matmul_ref
from repro_torch.kernels.doc_score.ref import doc_score_flat_ref, doc_score_fwd_ref
from repro_torch.kernels.sbmax.ref import sbmax_ref

TOL = dict(rtol=1e-5, atol=1e-4)
# tests/test_kernels.py's dequant_matmul tolerances (sums of up to 512
# products of order 10^2, in another order; the Pallas kernel multiplies
# bfloat16 x in bfloat16)
DEQUANT_TOL = {"float32": dict(rtol=1e-5, atol=1e-2), "bfloat16": dict(rtol=2e-2, atol=1e-2)}

SBMAX_SHAPES = [(64, 1024, 2, 8), (300, 2048, 3, 17), (17, 3072, 1, 3)]
# (v, n, q, nq) on the card only: more term slots than one chunk staged in
# shared memory (two chunks, the sums kept across them); rows that are no
# multiple of the kernel's 256-word tile (at granule 2, not of 4 words either:
# 4-byte loads); more queries than a grid's y dimension holds
SBMAX_CUDA_SHAPES = [(300, 2048, 3, 5000), (64, 4008, 5, 40), (40, 1024, 70_000, 3)]
BOUNDSUM_GRID = [(4, 8), (4, 16), (4, 64), (8, 4), (8, 16)]
DOC_SCORE_SHAPES = [(32, 8, 16, 64, 2, 5), (17, 4, 24, 300, 3, 9), (8, 16, 8, 33, 1, 3)]
DOC_SCORE_FLAT_SHAPES = [(24, 8, 40, 64, 2, 6), (9, 4, 16, 120, 3, 4)]
DEQUANT_SHAPES = [(64, 256, 1), (128, 512, 2)]  # (M, K, 128-word segments)
# (pattern, density) of block masks: the traversal's masks are row prefixes
# (full-width cut, competitive cut), ranges not starting at 0 (bmp), all
# ones (round 0) and phase 2's eligibility (a few ranks past round 0's);
# random masks hold the kernels to no order at all
MASKS = [("prefix", 0.0), ("prefix", 1.0)] + [(p, d) for p in ("prefix", "range", "random") for d in (0.001, 0.5)]
MASKS += [(p, d) for p in ("range", "random") for d in (0.0, 1.0)]
# (nb, b, T, vocab, Q, S): block rows of 16-byte multiples (bulk copies; T = 88
# is the synthetic index's t_pad), rows that are not at 8 bits (plain loads)
# over more (q, s) pairs than one window of every thread block, a query row
# too long for shared memory (every lookup through L2), and more queries than
# the card has SMs (one thread block a query)
MASKED_DOC_SCORE_SHAPES = [(64, 8, 88, 300, 4, 2000), (64, 8, 13, 300, 64, 4000), (64, 8, 88, 60_000, 4, 2000),
                           (64, 8, 88, 300, 200, 40)]
# (nb, b, m, vocab, Q, S) over the flat layout: bulk copies of uint8 rows that
# start 8 bytes past a 16-byte boundary (m = 392), of id rows that start off
# one too (m = 50), over many windows; plain loads where the weight tensor's
# size is no multiple of 16 bytes (63 x 20); a query row too long for shared
# memory (every lookup through L2); more queries than SMs; more documents a
# block than a warp has lanes (b = 40)
MASKED_DOC_SCORE_FLAT_SHAPES = [(64, 8, 392, 300, 4, 2000), (64, 8, 50, 300, 64, 4000), (63, 8, 20, 300, 4, 2000),
                                (64, 8, 392, 60_000, 4, 2000), (64, 8, 50, 300, 200, 40), (64, 40, 400, 300, 4, 200)]
# (v, ns, Q, nq, S) for masked boundsum_gather: phase 2's shape (Q = 64,
# S = budget = 250, many windows of 32) and more term slots than one chunk
# staged in shared memory (two chunks, the sums kept across them)
MASKED_BOUNDSUM_SHAPES = [(300, 250, 64, 40, 250), (200, 40, 3, 5000, 70)]


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


def _boundsum_inputs(bits, c, v=150, ns=30, q=2, nq=9, s=7):
    """Packed bounds, query terms and selected superblocks; on shapes other
    than the default a third of the term weights are 0 (pruned terms)."""
    rng = np.random.default_rng(c)
    mat = rng.integers(0, 1 << bits, (v, ns * c)).astype(np.uint8)
    tids = rng.integers(0, v, (q, nq)).astype(np.int32)
    ws = rng.random((q, nq)).astype(np.float32)
    if (v, ns, q, nq, s) != (150, 30, 2, 9, 7):
        ws[rng.random((q, nq)) < 1 / 3] = 0.0
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


def _block_mask(pattern: str, density: float, q: int, s: int) -> np.ndarray:
    """bool [q, s]: per row a prefix or a range of Binomial(s, density) live
    blocks, or each block live with probability ``density``."""
    rng = np.random.default_rng(q * s)
    if pattern == "random":
        return rng.random((q, s)) < density
    n = rng.binomial(s, density, q)
    start = np.zeros(q, np.int64) if pattern == "prefix" else rng.integers(0, s - n + 1)
    cols = np.arange(s)[None, :]
    return (cols >= start[:, None]) & (cols < (start + n)[:, None])


def _doc_score_flat_inputs(nb, b, m, vocab, q, s, bits=8):
    """Per-block postings sorted by local doc: runs end at doc_ends, the
    rest of each segment is padding (sentinel tid, zero weight)."""
    rng = np.random.default_rng(nb * 7 + m)
    counts = rng.integers(0, m // b + 1, (nb, b))
    doc_ends = np.cumsum(counts, axis=1).astype(np.int32)
    tids = np.full((nb, m), vocab, np.int32)
    ws = np.zeros((nb, m), np.uint8 if bits == 8 else np.uint16)
    for k in range(nb):
        n = doc_ends[k, -1]
        tids[k, :n] = rng.integers(0, vocab, n)
        ws[k, :n] = rng.integers(0, 1 << bits, n)
    qdense = rng.standard_normal((q, vocab + 1)).astype(np.float32)
    qdense[:, vocab] = 0.0
    blk = rng.integers(0, nb, (q, s)).astype(np.int32)
    return tids, ws, doc_ends, qdense, blk


def _dequant_inputs(bits, m, k, segs):
    """float32 x [m, k] and a random bits-wide [k, segs*128*vpw] matrix packed at granule 128."""
    rng = np.random.default_rng(m + k)
    w = rng.integers(0, 1 << bits, (k, (32 // bits) * SEG_WORDS * segs)).astype(np.uint8)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return x, _pack(w, bits, SEG_WORDS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("granule", [SEG_WORDS, 2, 4, 3])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("v,n,q,nq", SBMAX_SHAPES + SBMAX_CUDA_SHAPES)
def test_sbmax_cuda_matches_plain(cuda, bits, v, n, q, nq, granule):
    """Granules of the superblock matrices (128), of the block matrix at
    c = 16 (2 words at 4 bits, 4 at 8) and one that is no power of two (3
    words: c = 24 at 4 bits, c = 12 at 8), whose outputs the kernel stores
    bit-lane by bit-lane; where there are two queries or more, the first has
    no term of nonzero weight and the last names one term twice."""
    from repro_torch.kernels.sbmax.kernel import sbmax_kernel

    packed, tids, ws = _sbmax_inputs(bits, v, n, q, nq, granule)
    if q > 1:
        ws[0] = 0.0
    if nq > 1:
        tids[-1, 1] = tids[-1, 0]
    packed, tids, ws = (_t(a, cuda) for a in (packed, tids, ws))
    got = sbmax_kernel(packed, tids, ws, bits, granule)
    want = sbmax_ref(packed, tids, ws, bits, granule)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    if q > 1:
        assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("bits,granule,n", [(4, SEG_WORDS, 8192), (4, 2, 131_072), (8, 4, 65_536)])
def test_sbmax_cuda_repeats_bit_identically(cuda, bits, granule, n):
    """Phase 1's width and bmp's (the block matrix at c = 16): the same
    inputs give the same bits on every launch (each sum in one thread, in
    term order)."""
    from repro_torch.kernels.sbmax.kernel import sbmax_kernel

    packed, tids, ws = (_t(a, cuda) for a in _sbmax_inputs(bits, 400, n, 64, 34, granule))
    first = sbmax_kernel(packed, tids, ws, bits, granule)
    assert all(torch.equal(first.view(torch.int32), sbmax_kernel(packed, tids, ws, bits, granule).view(torch.int32))
               for _ in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("bits,c", BOUNDSUM_GRID)
def test_boundsum_gather_cuda_matches_plain(cuda, bits, c):
    from repro_torch.kernels.boundsum_gather.kernel import boundsum_gather_kernel

    packed, tids, ws, sel = (_t(a, cuda) for a in _boundsum_inputs(bits, c))
    live = torch.ones(sel.shape, dtype=torch.bool, device=cuda)
    got = boundsum_gather_kernel(packed, c, bits, tids, ws, sel, live)
    want = boundsum_gather_ref(packed, c, bits, tids, ws, sel, live)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,c", BOUNDSUM_GRID)
@pytest.mark.parametrize("v,ns,q,nq,s", MASKED_BOUNDSUM_SHAPES)
@pytest.mark.parametrize("pattern,density", MASKS)
def test_masked_boundsum_gather_cuda_matches_plain(cuda, pattern, density, v, ns, q, nq, s, bits, c):
    """Live entries equal the plain version's, masked ones are exactly 0."""
    from repro_torch.kernels.boundsum_gather.kernel import boundsum_gather_kernel

    packed, tids, ws, sel = (_t(a, cuda) for a in _boundsum_inputs(bits, c, v, ns, q, nq, s))
    mask = _t(_block_mask(pattern, density, q, s), cuda)
    got = boundsum_gather_kernel(packed, c, bits, tids, ws, sel, mask)
    want = boundsum_gather_ref(packed, c, bits, tids, ws, sel, mask)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert not got[~mask].any()


@pytest.mark.cuda
@pytest.mark.parametrize("v,ns,q,nq,s", MASKED_BOUNDSUM_SHAPES)
def test_boundsum_gather_cuda_reads_no_masked_granule(cuda, v, ns, q, nq, s):
    """Masked entries of sel hold superblock ids far past the matrix: a read
    of their granules faults at the synchronize."""
    from repro_torch.kernels.boundsum_gather.kernel import boundsum_gather_kernel

    bits, c = 4, 16
    packed, tids, ws, sel = (_t(a, cuda) for a in _boundsum_inputs(bits, c, v, ns, q, nq, s))
    mask = _t(_block_mask("random", 0.5, q, s), cuda)
    poisoned = torch.where(mask, sel, 1 << 28)
    got = boundsum_gather_kernel(packed, c, bits, tids, ws, poisoned, mask)
    torch.cuda.synchronize()
    want = boundsum_gather_ref(packed, c, bits, tids, ws, sel, mask)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert not got[~mask].any()


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("nb,b,t,vocab,q,s", DOC_SCORE_SHAPES)
def test_doc_score_fwd_cuda_matches_plain(cuda, nb, b, t, vocab, q, s, bits):
    from repro_torch.kernels.doc_score.kernel import doc_score_fwd_kernel

    tids, ws, qdense, blk = (_t(a, cuda) for a in _doc_score_inputs(nb, b, t, vocab, q, s, bits))
    live = torch.ones(blk.shape, dtype=torch.bool, device=cuda)
    got = doc_score_fwd_kernel(tids, ws, qdense, blk, live)
    want = doc_score_fwd_ref(tids, ws, qdense, blk, live)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("nb,b,t,vocab,q,s", MASKED_DOC_SCORE_SHAPES)
@pytest.mark.parametrize("pattern,density", MASKS)
def test_masked_doc_score_fwd_cuda_matches_plain(cuda, pattern, density, nb, b, t, vocab, q, s, bits):
    """Live entries equal the plain version's, masked ones are exactly 0,
    with the query row in shared memory (where it fits) and in L2. The query
    row is nonnegative, as query term weights are: with signed values, 16-bit
    weights and T = 88 the terms reach 2e5 and cancel, and any two float32
    summation orders then differ by up to 0.03 near zero (the signed rows are
    held to a float64 sum in the next test)."""
    from repro_torch.kernels.doc_score.kernel import doc_score_fwd_kernel

    tids, ws, qdense, blk = _doc_score_inputs(nb, b, t, vocab, q, s, bits)
    tids, ws, qdense, blk = (_t(a, cuda) for a in (tids, ws, np.abs(qdense), blk))
    mask = _t(_block_mask(pattern, density, q, s), cuda)
    got = doc_score_fwd_kernel(tids, ws, qdense, blk, mask)
    want = doc_score_fwd_ref(tids, ws, qdense, blk, mask)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert not got[~mask].any()


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("nb,b,t,vocab,q,s", [MASKED_DOC_SCORE_SHAPES[0], MASKED_DOC_SCORE_SHAPES[2]])
@pytest.mark.parametrize("pattern,density", [("prefix", 1.0), ("random", 0.5)])
def test_masked_doc_score_fwd_cuda_signed_within_float32_rounding(cuda, pattern, density, nb, b, t, vocab, q, s,
                                                                  bits):
    """Signed query rows at T = 88: each live entry is within the float32
    rounding of the kernel's summation order of the exact (float64) sum. A
    term is rounded once as a product, then in at most ceil(T/32) lane-strided
    adds and 5 shuffle adds, so its error is at most that many units of
    2^-24 of |term|: the bound scales with each document's sum of |terms|."""
    from repro_torch.kernels.doc_score.kernel import doc_score_fwd_kernel

    tids, ws, qdense, blk = (_t(a, cuda) for a in _doc_score_inputs(nb, b, t, vocab, q, s, bits))
    mask = _t(_block_mask(pattern, density, q, s), cuda)
    got = doc_score_fwd_kernel(tids, ws, qdense, blk, mask)
    exact = doc_score_fwd_ref(tids, ws, qdense.double(), blk, mask)
    magnitude = doc_score_fwd_ref(tids, ws, qdense.abs().double(), blk, mask)  # sum of |terms|, ws >= 0
    roundings = 1 + -(-t // 32) + 5
    assert ((got.double() - exact).abs() <= roundings * 2.0**-24 * magnitude).all()
    assert not got[~mask].any()


@pytest.mark.cuda
def test_cuda_kernels_repeat_bit_identically(cuda):
    """The same inputs give the same bits on every call (no atomics)."""
    from repro_torch.kernels.boundsum_gather.kernel import boundsum_gather_kernel
    from repro_torch.kernels.dequant_matmul.kernel import dequant_matmul_kernel
    from repro_torch.kernels.doc_score.kernel import doc_score_flat_kernel, doc_score_fwd_kernel

    x, packed = (_t(a, cuda) for a in _dequant_inputs(4, 64, 64, 1))
    first = dequant_matmul_kernel(x, packed, 4)
    assert all(torch.equal(first.view(torch.int32), dequant_matmul_kernel(x, packed, 4).view(torch.int32))
               for _ in range(3))
    nb, b, t, vocab, q, s = MASKED_DOC_SCORE_SHAPES[0]
    args = [_t(a, cuda) for a in _doc_score_inputs(nb, b, t, vocab, q, s)]
    args.append(_t(_block_mask("random", 0.5, q, s), cuda))
    first = doc_score_fwd_kernel(*args)
    assert all(torch.equal(first.view(torch.int32), doc_score_fwd_kernel(*args).view(torch.int32)) for _ in range(3))
    nb, b, m, vocab, q, s = MASKED_DOC_SCORE_FLAT_SHAPES[1]
    args = [_t(a, cuda) for a in _doc_score_flat_inputs(nb, b, m, vocab, q, s)]
    args.append(_t(_block_mask("random", 0.5, q, s), cuda))
    first = doc_score_flat_kernel(*args)
    assert all(torch.equal(first.view(torch.int32), doc_score_flat_kernel(*args).view(torch.int32)) for _ in range(3))
    v, ns, q, nq, s = MASKED_BOUNDSUM_SHAPES[0]
    packed, tids, ws, sel = (_t(a, cuda) for a in _boundsum_inputs(4, 16, v, ns, q, nq, s))
    mask = _t(_block_mask("random", 0.5, q, s), cuda)
    first = boundsum_gather_kernel(packed, 16, 4, tids, ws, sel, mask)
    assert all(torch.equal(first.view(torch.int32),
                           boundsum_gather_kernel(packed, 16, 4, tids, ws, sel, mask).view(torch.int32))
               for _ in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("nb,b,m,vocab,q,s", DOC_SCORE_FLAT_SHAPES)
def test_doc_score_flat_cuda_matches_plain(cuda, nb, b, m, vocab, q, s, bits):
    from repro_torch.kernels.doc_score.kernel import doc_score_flat_kernel

    args = [_t(a, cuda) for a in _doc_score_flat_inputs(nb, b, m, vocab, q, s, bits)]
    args.append(torch.ones((q, s), dtype=torch.bool, device=cuda))
    got = doc_score_flat_kernel(*args)
    want = doc_score_flat_ref(*args)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("nb,b,m,vocab,q,s", MASKED_DOC_SCORE_FLAT_SHAPES)
@pytest.mark.parametrize("pattern,density", MASKS)
def test_masked_doc_score_flat_cuda_matches_plain(cuda, pattern, density, nb, b, m, vocab, q, s, bits):
    """Live entries equal the plain version's, masked ones are exactly 0, on
    bulk copies of rows aligned and not, plain loads, and the query row in
    shared memory and in L2. The query row is nonnegative, as in the fwd test
    above."""
    from repro_torch.kernels.doc_score.kernel import doc_score_flat_kernel

    tids, ws, doc_ends, qdense, blk = _doc_score_flat_inputs(nb, b, m, vocab, q, s, bits)
    args = [_t(a, cuda) for a in (tids, ws, doc_ends, np.abs(qdense), blk)]
    mask = _t(_block_mask(pattern, density, q, s), cuda)
    got = doc_score_flat_kernel(*args, mask)
    want = doc_score_flat_ref(*args, mask)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert not got[~mask].any()


def _poison_masked_blocks(blk: np.ndarray, mask: np.ndarray, nb: int) -> tuple[np.ndarray, np.ndarray]:
    """Block ids where the live pairs use blocks [0, nb/2) only and the masked
    pairs blocks [nb/2, nb) only; and those masked-only blocks' ids."""
    half = nb // 2
    return np.where(mask, blk % half, half + blk % half).astype(np.int32), np.arange(half, nb)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,shape", [("fwd", 0), ("fwd", 1), ("fwd", 2), ("fwd", 3), ("flat", 0), ("flat", 2),
                                          ("flat", 3), ("flat", 4)])
def test_doc_score_cuda_reads_no_masked_block(cuda, layout, shape):
    """The blocks that only masked pairs select hold term ids far past the
    query row: a lookup of one of them faults at the synchronize. Over bulk
    copies, plain loads and the query row in L2."""
    from repro_torch.kernels.doc_score.kernel import doc_score_flat_kernel, doc_score_fwd_kernel

    if layout == "flat":
        nb, b, m, vocab, q, s = MASKED_DOC_SCORE_FLAT_SHAPES[shape]
        tids, ws, doc_ends, qdense, blk = _doc_score_flat_inputs(nb, b, m, vocab, q, s)
        kernel, plain, rest = doc_score_flat_kernel, doc_score_flat_ref, (ws, doc_ends)
    else:
        nb, b, t, vocab, q, s = MASKED_DOC_SCORE_SHAPES[shape]
        tids, ws, qdense, blk = _doc_score_inputs(nb, b, t, vocab, q, s)
        kernel, plain, rest = doc_score_fwd_kernel, doc_score_fwd_ref, (ws,)
    mask = _block_mask("random", 0.5, q, s)
    blk, dead = _poison_masked_blocks(blk, mask, nb)
    poisoned = tids.copy()
    poisoned[dead] = 1 << 30
    rest = [_t(a, cuda) for a in rest]
    qdense, blk, mask = _t(np.abs(qdense), cuda), _t(blk, cuda), _t(mask, cuda)
    got = kernel(_t(poisoned, cuda), *rest, qdense, blk, mask)
    torch.cuda.synchronize()
    want = plain(_t(tids, cuda), *rest, qdense, blk, mask)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert not got[~mask].any()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 100, 300])
@pytest.mark.parametrize("m", [1, 3, 64, 100, 128, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8])
def test_dequant_matmul_cuda_matches_plain(cuda, bits, dtype, m, k):
    """Every row tiling the launch picks (8, 4, 2 and 1 rows a thread block),
    M that is not a multiple of it, K that is not a multiple of the warps or of
    the 128-deep shared-memory slice; 128 packed words at the dense path's
    K = 64, 256 otherwise. Kernel and plain version both sum in float32 from
    the same exact values, so both dtypes are held at the float32 tolerance."""
    from repro_torch.kernels.dequant_matmul.kernel import dequant_matmul_kernel

    x, packed = _dequant_inputs(bits, m, k, 1 if k == 64 else 2)
    x, packed = _t(x, cuda).to(getattr(torch, dtype)), _t(packed, cuda)
    got = dequant_matmul_kernel(x, packed, bits)
    want = dequant_matmul_ref(x, packed, bits)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **DEQUANT_TOL["float32"])


def _search_kernel_vs_ref(cuda, doc_bits, doc_layout):
    """A small index built on the card, searched through impl="kernel" and
    impl="ref"; the exact backend returns k valid docs on every query."""
    from repro_torch.api import Retriever, SearchRequest, StaticConfig
    from repro_torch.data.synthetic import CorpusConfig, make_corpus, make_queries
    from repro_torch.index.builder import IndexBuildConfig

    ccfg = CorpusConfig(n_docs=8192, vocab=2048, n_topics=16, seed=0)
    corpus = make_corpus(ccfg)
    requests = [SearchRequest(t, w) for t, w in make_queries(ccfg, corpus, 32)]
    scfg = StaticConfig(gamma=16, gamma0=4, doc_layout=doc_layout)
    kern = Retriever.build(corpus, scfg, build_cfg=IndexBuildConfig(b=8, c=16, kmeans_iters=2, doc_bits=doc_bits),
                           impl="kernel", device=cuda)
    ref = Retriever.from_index(kern.index, scfg, impl="ref", device=cuda)
    for a, b in zip(kern.search_batch(requests), ref.search_batch(requests)):
        np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
        assert (a.n_superblocks_visited, a.n_blocks_scored) == (b.n_superblocks_visited, b.n_blocks_scored)
        np.testing.assert_allclose(a.scores, b.scores, rtol=1e-5, atol=1e-5)
    exact = Retriever.from_index(kern.index, scfg, backend="exact", device=cuda)
    assert all((r.doc_ids >= 0).all() for r in exact.search_batch(requests))


@pytest.mark.cuda
@pytest.mark.parametrize("doc_bits", [8, 16])
def test_search_kernel_path_matches_ref_path(cuda, doc_bits):
    _search_kernel_vs_ref(cuda, doc_bits, "fwd")


@pytest.mark.cuda
@pytest.mark.parametrize("doc_bits", [8, 16])
def test_flat_search_kernel_path_matches_ref_path(cuda, doc_bits):
    _search_kernel_vs_ref(cuda, doc_bits, "flat")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["lsp0", "lsp1"])
def test_dense_kernel_path_matches_ref_path(cuda, variant):
    """A small dense index built on the card: retrieve_dense through the
    dequant_matmul kernel and through its plain version return the same ids."""
    from repro_torch.core.config import RetrievalConfig
    from repro_torch.core.lsp_dense import DenseIndexConfig, build_dense_index, retrieve_dense

    rng = np.random.default_rng(0)
    centers = rng.standard_normal((16, 32)).astype(np.float32)
    cands = (centers[rng.integers(0, 16, 8000)] + 0.3 * rng.standard_normal((8000, 32))).astype(np.float32)
    q = (centers[rng.integers(0, 16, 6)] + 0.2 * rng.standard_normal((6, 32))).astype(np.float32)
    idx = build_dense_index(cands, DenseIndexConfig(b=32, c=8, kmeans_iters=3, ns_align=4), device=cuda)
    cfg = RetrievalConfig(variant=variant, k=10, gamma=4, gamma0=2)
    ids_k, vals_k = retrieve_dense(idx, q, cfg, impl="kernel")
    ids_r, vals_r = retrieve_dense(idx, q, cfg, impl="ref")
    np.testing.assert_array_equal(ids_k.cpu().numpy(), ids_r.cpu().numpy())
    np.testing.assert_allclose(vals_k.cpu().numpy(), vals_r.cpu().numpy(), rtol=1e-5, atol=1e-5)
