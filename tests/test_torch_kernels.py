"""The port's plain kernel versions against the JAX package's Pallas kernels
(interpret mode), on the shape and bit grids of tests/test_kernels.py and
tests/test_doc_score.py (the flat one at 16-bit weights too). tests/test_torch_kernels_cuda.py holds each CUDA
kernel against these plain versions on the card.
Tolerances rtol=1e-5, atol=1e-4: the sums run in float32 in another order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bounds import bound_scores
from repro.index.layout import FlatDocsQ, FwdDocsQ, PackedBounds
from repro.kernels.boundsum_gather.kernel import boundsum_gather_pallas
from repro.kernels.dequant_matmul.kernel import dequant_matmul_pallas
from repro.kernels.doc_score.kernel import doc_score_flat_pallas, doc_score_fwd_pallas
from repro.kernels.doc_score.ref import doc_score_flat_ref as jax_doc_score_flat_ref
from repro.kernels.doc_score.ref import doc_score_fwd_ref as jax_doc_score_fwd_ref
from repro.kernels.sbmax.kernel import sbmax_pallas
from repro_torch.index.pack import SEG_WORDS
from repro_torch.kernels.boundsum_gather.ref import boundsum_gather_ref
from repro_torch.kernels.dequant_matmul.ref import dequant_matmul_ref
from repro_torch.kernels.doc_score.ref import doc_score_flat_ref, doc_score_fwd_ref
from repro_torch.kernels.sbmax.ref import sbmax_ref
from test_torch_kernels_cuda import (
    BOUNDSUM_GRID,
    DEQUANT_SHAPES,
    DEQUANT_TOL,
    DOC_SCORE_FLAT_SHAPES,
    DOC_SCORE_SHAPES,
    SBMAX_SHAPES,
    TOL,
    _block_mask,
    _boundsum_inputs,
    _doc_score_flat_inputs,
    _doc_score_inputs,
    _dequant_inputs,
    _sbmax_inputs,
    _t,
)


def _u32(a: np.ndarray) -> np.ndarray:
    """Packed words as the JAX package holds them (uint32)."""
    return a.view(np.uint32) if a.dtype == np.int32 else a


# ----------------------------------------------------------------- CPU: plain vs Pallas


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("v,n,q,nq", SBMAX_SHAPES)
def test_sbmax_plain_matches_pallas(bits, v, n, q, nq):
    packed, tids, ws = _sbmax_inputs(bits, v, n, q, nq)
    want = sbmax_pallas(jnp.asarray(_u32(packed)), jnp.asarray(tids), jnp.asarray(ws), bits, interpret=True)
    got = sbmax_ref(_t(packed), _t(tids), _t(ws), bits, SEG_WORDS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bits,c", BOUNDSUM_GRID)
def test_boundsum_gather_plain_matches_pallas(bits, c):
    packed, tids, ws, sel = _boundsum_inputs(bits, c)
    want = boundsum_gather_pallas(jnp.asarray(_u32(packed)), c, bits, jnp.asarray(tids), jnp.asarray(ws),
                                  jnp.asarray(sel), interpret=True)
    got = boundsum_gather_ref(_t(packed), c, bits, _t(tids), _t(ws), _t(sel), torch.ones(sel.shape, dtype=torch.bool))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@functools.lru_cache(maxsize=None)
def _boundsum_pallas(bits, c):
    """One input set of the (bits, c) grid and its unmasked sums from the
    Pallas kernel (interpret mode)."""
    arrays = _boundsum_inputs(bits, c)
    packed, tids, ws, sel = arrays
    want = boundsum_gather_pallas(jnp.asarray(_u32(packed)), c, bits, jnp.asarray(tids), jnp.asarray(ws),
                                  jnp.asarray(sel), interpret=True)
    return arrays, np.asarray(want)


@pytest.mark.parametrize("bits,c", BOUNDSUM_GRID)
@pytest.mark.parametrize("pattern,density", [("prefix", 0.0), ("range", 0.5), ("random", 0.5)])
def test_masked_boundsum_gather_plain_matches_pallas(pattern, density, bits, c):
    """The masked plain version against the Pallas kernel masked afterwards:
    all zeros, a middle range (phase 2's eligible ranks) and random masks."""
    (packed, tids, ws, sel), pallas = _boundsum_pallas(bits, c)
    mask = _block_mask(pattern, density, *sel.shape)
    got = boundsum_gather_ref(_t(packed), c, bits, _t(tids), _t(ws), _t(sel), _t(mask)).numpy()
    np.testing.assert_allclose(got, np.where(mask[:, :, None], pallas, 0.0), **TOL)
    assert not got[~mask].any()


@pytest.mark.parametrize("nb,b,t,vocab,q,s", DOC_SCORE_SHAPES)
def test_doc_score_fwd_plain_matches_pallas(nb, b, t, vocab, q, s):
    tids, ws, qdense, blk = _doc_score_inputs(nb, b, t, vocab, q, s)
    want = doc_score_fwd_pallas(jnp.asarray(tids), jnp.asarray(ws), jnp.asarray(qdense),
                                jnp.asarray(blk), interpret=True)
    got = doc_score_fwd_ref(_t(tids), _t(ws), _t(qdense), _t(blk), torch.ones(blk.shape, dtype=torch.bool))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@functools.lru_cache(maxsize=None)
def _pallas_and_jax_ref(layout, bits):
    """One input set of ``layout`` ("fwd" or "flat") at ``bits``-wide weights
    and its unmasked raw scores from the Pallas kernel (interpret mode) and
    the JAX plain version."""
    if layout == "flat":
        nb, b, m, vocab, q, s = DOC_SCORE_FLAT_SHAPES[0]
        arrays = _doc_score_flat_inputs(nb, b, m, vocab, q, s, bits)
        tids, ws, doc_ends, qdense, blk = (jnp.asarray(a) for a in arrays)
        pallas = doc_score_flat_pallas(tids, ws, doc_ends, qdense, blk, interpret=True)
        jax_ref = jax_doc_score_flat_ref(FlatDocsQ(tids, ws, doc_ends, None, bits, m), qdense, blk)
        return arrays, np.asarray(pallas), np.asarray(jax_ref)
    arrays = _doc_score_inputs(*DOC_SCORE_SHAPES[1], bits)
    tids, ws, qdense, blk = (jnp.asarray(a) for a in arrays)
    pallas = doc_score_fwd_pallas(tids, ws, qdense, blk, interpret=True)
    jax_ref = jax_doc_score_fwd_ref(FwdDocsQ(tids, ws, None, bits, tids.shape[2]), qdense, blk)
    return arrays, np.asarray(pallas), np.asarray(jax_ref)


@pytest.mark.parametrize("layout", ["fwd", "flat"])
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("pattern,density", [("prefix", 1.0), ("prefix", 0.0), ("prefix", 0.5), ("range", 0.5),
                                             ("random", 0.5)])
def test_masked_doc_score_fwd_plain_matches_pallas(pattern, density, bits, layout):
    """The masked plain version of each layout against its Pallas kernel and
    its JAX plain version, both masked afterwards: all ones, all zeros, a
    prefix, a middle range and random masks. The flat JAX plain version is
    held at 8 bits only: its float32 prefix sums miss the tolerance at 16
    (``test_float32_prefix_sums_miss_the_tolerance_at_16_bits``)."""
    arrays, pallas, jax_ref = _pallas_and_jax_ref(layout, bits)
    plain = doc_score_flat_ref if layout == "flat" else doc_score_fwd_ref
    q, s = arrays[-1].shape
    mask = _block_mask(pattern, density, q, s)
    got = plain(*(_t(a) for a in arrays), _t(mask)).numpy()
    np.testing.assert_allclose(got, np.where(mask[:, :, None], pallas, 0.0), **TOL)
    if layout == "fwd" or bits == 8:
        np.testing.assert_allclose(got, np.where(mask[:, :, None], jax_ref, 0.0), **TOL)
    assert not got[~mask].any()


def _flat_three_ways(nb, b, m, vocab, q, s, bits):
    """(port plain version, Pallas kernel in interpret mode, JAX plain version)."""
    arrays = _doc_score_flat_inputs(nb, b, m, vocab, q, s, bits)
    tids, ws, doc_ends, qdense, blk = (jnp.asarray(a) for a in arrays)
    pallas = doc_score_flat_pallas(tids, ws, doc_ends, qdense, blk, interpret=True)
    jax_ref = jax_doc_score_flat_ref(FlatDocsQ(tids, ws, doc_ends, None, bits, m), qdense, blk)
    got = doc_score_flat_ref(*(_t(a) for a in arrays), torch.ones((q, s), dtype=torch.bool))
    return got.numpy(), np.asarray(pallas), np.asarray(jax_ref)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("nb,b,m,vocab,q,s", DOC_SCORE_FLAT_SHAPES)
def test_doc_score_flat_plain_matches_pallas(nb, b, m, vocab, q, s, bits):
    got, pallas, jax_ref = _flat_three_ways(nb, b, m, vocab, q, s, bits)
    np.testing.assert_allclose(got, pallas, **TOL)
    if bits == 8:  # tests/test_doc_score.py's grid; see the test below for 16 bits
        np.testing.assert_allclose(got, jax_ref, **TOL)


def test_float32_prefix_sums_miss_the_tolerance_at_16_bits():
    """Pins why the port's flat plain version takes its prefix sums in
    float64: with 16-bit weights the JAX version's float32 prefix sums over a
    block (totals ~1e5) miss rtol=1e-5, atol=1e-4 against the Pallas kernel's
    direct per-document sums, which the port's plain version holds."""
    got, pallas, jax_ref = _flat_three_ways(*DOC_SCORE_FLAT_SHAPES[0], 16)
    np.testing.assert_allclose(got, pallas, **TOL)
    assert not np.allclose(jax_ref, pallas, **TOL)


@pytest.mark.parametrize("m,k,segs", DEQUANT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8])
def test_dequant_matmul_plain_matches_pallas(bits, dtype, m, k, segs):
    x, packed = _dequant_inputs(bits, m, k, segs)
    want = dequant_matmul_pallas(jnp.asarray(x).astype(dtype), jnp.asarray(_u32(packed)), bits, tm=64,
                                 tk=min(256, k), interpret=True)
    got = dequant_matmul_ref(_t(x).to(getattr(torch, dtype)), _t(packed), bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEQUANT_TOL[dtype])


@pytest.mark.parametrize("bits,granule", [(4, 2), (8, 4)])
def test_sbmax_pallas_misplaces_values_below_tile_granule(bits, granule):
    """Pins a fault of the JAX reference: ``sbmax_pallas`` unpacks 128-word
    tiles only, so on a matrix packed at a smaller granule (bmp's block matrix,
    c*bits/32 words) it disagrees with the JAX package's own ``bound_scores``.
    The port's plain version (and its CUDA kernel) take the granule and agree."""
    packed, tids, ws = _sbmax_inputs(bits, 64, 1024, 2, 8, granule)
    n = packed.shape[1] * 32 // bits
    want = np.asarray(bound_scores(PackedBounds(jnp.asarray(_u32(packed)), bits, 1.0, n, granule),
                                   jnp.asarray(tids), jnp.asarray(ws)))
    pallas = np.asarray(sbmax_pallas(jnp.asarray(_u32(packed)), jnp.asarray(tids), jnp.asarray(ws), bits,
                                     interpret=True))
    got = sbmax_ref(_t(packed), _t(tids), _t(ws), bits, granule)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not np.allclose(pallas, want, **TOL)
    np.testing.assert_allclose(np.sort(pallas, axis=1), np.sort(want, axis=1), **TOL)  # same values, other lanes


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.sbmax.kernel import sbmax_kernel

    packed, tids, ws = _sbmax_inputs(4, 64, 1024, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sbmax_kernel(_t(packed), _t(tids), _t(ws), 4, SEG_WORDS)
    assert sbmax_kernel.launches == 0


@pytest.mark.parametrize("change", ["bits 16", "granule 0", "granule not dividing W", "ws shape", "tids rank"])
def test_sbmax_wrapper_refuses_bad_shapes_before_launch(change):
    """Bad bits or shapes are refused before the tensors' device is looked at,
    so before anything is built or launched."""
    from repro_torch.kernels.sbmax.kernel import sbmax_kernel

    packed, tids, ws = (_t(a) for a in _sbmax_inputs(4, 64, 1024, 2, 8))  # W = 128 words
    bits, granule = 4, SEG_WORDS
    if change == "bits 16":
        bits = 16
    elif change == "granule 0":
        granule = 0
    elif change == "granule not dividing W":
        granule = 3
    elif change == "ws shape":
        ws = ws[:, :-1]
    else:
        tids = tids[0]
    with pytest.raises(ValueError, match="bits must be|bad shapes"):
        sbmax_kernel(packed, tids, ws, bits, granule)
    assert sbmax_kernel.launches == 0


def test_sbmax_wrapper_takes_any_number_of_queries():
    """No limit on the number of queries (the grid is 1-D): 70,000 rows pass
    the shape checks and are refused only for lying on the CPU."""
    from repro_torch.kernels.sbmax.kernel import sbmax_kernel

    packed, _, _ = _sbmax_inputs(4, 64, 1024, 2, 8)
    tids = torch.zeros((70_000, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sbmax_kernel(_t(packed), tids, torch.ones((70_000, 3)), 4, SEG_WORDS)
