"""The port's plain kernel versions against the JAX package's Pallas kernels
(interpret mode), on the shape and bit grids of tests/test_kernels.py and
tests/test_doc_score.py. tests/test_torch_kernels_cuda.py holds each CUDA
kernel against these plain versions on the card.
Tolerances rtol=1e-5, atol=1e-4: the sums run in float32 in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.bounds import bound_scores
from repro.index.layout import PackedBounds
from repro.kernels.boundsum_gather.kernel import boundsum_gather_pallas
from repro.kernels.doc_score.kernel import doc_score_fwd_pallas
from repro.kernels.sbmax.kernel import sbmax_pallas
from repro_torch.index.pack import SEG_WORDS
from repro_torch.kernels.boundsum_gather.ref import boundsum_gather_ref
from repro_torch.kernels.doc_score.ref import doc_score_fwd_ref
from repro_torch.kernels.sbmax.ref import sbmax_ref
from test_torch_kernels_cuda import (
    BOUNDSUM_GRID,
    DOC_SCORE_SHAPES,
    SBMAX_SHAPES,
    TOL,
    _boundsum_inputs,
    _doc_score_inputs,
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
    got = boundsum_gather_ref(_t(packed), c, bits, _t(tids), _t(ws), _t(sel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("nb,b,t,vocab,q,s", DOC_SCORE_SHAPES)
def test_doc_score_fwd_plain_matches_pallas(nb, b, t, vocab, q, s):
    tids, ws, qdense, blk = _doc_score_inputs(nb, b, t, vocab, q, s)
    want = doc_score_fwd_pallas(jnp.asarray(tids), jnp.asarray(ws), jnp.asarray(qdense),
                                jnp.asarray(blk), interpret=True)
    got = doc_score_fwd_ref(_t(tids), _t(ws), _t(qdense), _t(blk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
