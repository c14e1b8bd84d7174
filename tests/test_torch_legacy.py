"""The port's impl="legacy" traversal against the JAX package's, and the
public functions of ported modules that the port carries, each against the
JAX package's on the same seeded inputs.

Legacy (the profiling baseline from before the document-scoring kernels):
on ``tiny_index``/``tiny_qb`` at lsp0, lsp2 and bmp, doc ids, θ and both
visit counters equal JAX's legacy and the port's own impl="ref"; scores
rtol 1e-5, atol 1e-5 (float32 sums in another order). The packers are held
to the bit, the byte formulas and metrics equal, the bound sums and tree
helpers to float32 tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.common.tree_utils as jtree
import repro.core.bounds as jbounds
import repro.core.config as jconfig
import repro.eval.metrics as jmetrics
import repro.index.layout as jlayout
import repro.index.pack as jpack
import repro.index.quantize as jquantize
from repro.core import jit_search as jax_jit_search
from repro.core.config import StaticConfig as JaxStaticConfig
from repro_torch import api
from repro_torch.common import tree_utils
from repro_torch.core import bounds, config
from repro_torch.core.config import StaticConfig
from repro_torch.core.lsp import make_search_runner, search_retrieve
from repro_torch.core.query import QueryBatch
from repro_torch.distributed.sharded import ShardedRetriever
from repro_torch.eval import metrics
from repro_torch.index import layout, pack, quantize
from repro_torch.index.convert import from_arrays

TOL = dict(rtol=1e-5, atol=1e-5)
LEGACY = {
    "lsp0": dict(variant="lsp0", gamma=8, gamma0=2),
    "lsp2": dict(variant="lsp2", gamma=8, gamma0=4),
    "bmp": dict(variant="bmp", gamma=16, gamma0=4),
}


@pytest.fixture(scope="module")
def port_index(tiny_index):
    return from_arrays(tiny_index, torch.device("cpu"))


@pytest.fixture(scope="module")
def port_qb(tiny_qb):
    return QueryBatch(torch.from_numpy(np.array(tiny_qb.tids)), torch.from_numpy(np.array(tiny_qb.ws)),
                      tiny_qb.vocab)


def _same(got, want, scores=True):
    np.testing.assert_array_equal(got.doc_ids.numpy(), np.asarray(want.doc_ids))
    np.testing.assert_array_equal(got.n_superblocks_visited.numpy(), np.asarray(want.n_superblocks_visited))
    np.testing.assert_array_equal(got.n_blocks_scored.numpy(), np.asarray(want.n_blocks_scored))
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta), **TOL)
    if scores:
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), **TOL)


@pytest.mark.parametrize("variant", list(LEGACY))
def test_legacy_equals_jax_legacy_and_ref(tiny_index, tiny_qb, port_index, port_qb, variant):
    scfg = LEGACY[variant]
    want = jax_jit_search(tiny_index, JaxStaticConfig(**scfg), impl="legacy")(tiny_qb)
    got = search_retrieve(port_index, port_qb, StaticConfig(**scfg), impl="legacy")
    _same(got, want)
    _same(got, search_retrieve(port_index, port_qb, StaticConfig(**scfg), impl="ref"))
    # through the runner every backend builds on
    _same(make_search_runner(port_index, StaticConfig(**scfg), impl="legacy")(port_qb), want)


def test_legacy_stays_off_the_sharded_path_and_ops(port_index):
    with pytest.raises(ValueError, match="impl"):
        ShardedRetriever(port_index, StaticConfig(variant="lsp0", gamma=8, gamma0=2), n_shards=2, impl="legacy")
    with pytest.raises(ValueError, match="impl"):
        search_retrieve(port_index, None, StaticConfig(), impl="fast")


# ------------------------------------------------------------------ the packers, to the bit
@pytest.mark.parametrize("bits", [4, 8])
def test_packers_equal_jax_to_the_bit(bits):
    rng = np.random.default_rng(bits)
    q = rng.integers(0, 1 << bits, (5, 301)).astype(np.uint8)
    t = torch.from_numpy(q)
    words = pack.pack_rows(t, bits)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), jpack.pack_rows(q, bits))
    np.testing.assert_array_equal(pack.unpack_rows(words, bits, 301).numpy(), jpack.unpack_rows(
        jpack.pack_rows(q, bits), bits, 301))
    for g in (2, 128):
        sw = pack.pack_rows_strided(t, bits, g)
        np.testing.assert_array_equal(sw.numpy().view(np.uint32), jpack.pack_rows_strided(q, bits, g))
        back = pack.unpack_rows_strided(sw, bits, g, 301)
        assert back.dtype == torch.uint8
        np.testing.assert_array_equal(back.numpy(), jpack.unpack_rows_strided(jpack.pack_rows_strided(q, bits, g),
                                                                              bits, g, 301))
        np.testing.assert_array_equal(back.numpy(), q)
    for width, fill in ((400, 7), (100, 0)):
        np.testing.assert_array_equal(pack.pad_last(t, width, fill).numpy(), jpack.pad_last(q, width, fill))


def test_dequantize_equals_jax():
    q = np.random.default_rng(1).integers(0, 16, (7, 9)).astype(np.uint8)
    np.testing.assert_array_equal(quantize.dequantize(torch.from_numpy(q), 0.37).numpy(),
                                  jquantize.dequantize(q, 0.37))


# ------------------------------------------------------------------ the byte formulas on tiny_index
def test_byte_formulas_equal_jax(tiny_index, port_index):
    j, p = tiny_index, port_index
    assert layout.fwdq_bytes(p.docs_fwdq) == jlayout.fwdq_bytes(j.docs_fwdq)
    assert layout.flatq_bytes(p.docs_flatq) == jlayout.flatq_bytes(j.docs_flatq)
    for name in ("sb_bounds", "blk_bounds", "sb_avg"):
        assert layout.packed_bounds_bytes(getattr(p, name)) == jlayout.packed_bounds_bytes(getattr(j, name))
    # the distinct terms of each block, from the forward index
    tids = np.asarray(j.docs_fwd.tids).reshape(j.n_blocks, -1)
    vpb = np.array([len(np.setdiff1d(np.unique(r), [j.vocab])) for r in tids])
    nnz = int((np.asarray(j.docs_fwd.tids) < j.vocab).sum())
    for fn in ("bmp_inv_bytes", "compact_inv_bytes"):
        want = getattr(jlayout, fn)(nnz, j.n_blocks, vpb)
        assert getattr(layout, fn)(nnz, j.n_blocks, vpb) == want
        assert getattr(layout, fn)(nnz, j.n_blocks, torch.from_numpy(vpb)) == want
    assert layout.flat_inv_bytes(nnz, j.n_blocks) == jlayout.flat_inv_bytes(nnz, j.n_blocks)
    assert layout.fwd_bytes(len(j.doc_remap), j.docs_fwd.t_max) == jlayout.fwd_bytes(len(j.doc_remap),
                                                                                       j.docs_fwd.t_max)
    assert layout.dense_bounds_bytes(j.vocab, j.n_blocks, 4) == jlayout.dense_bounds_bytes(j.vocab, j.n_blocks, 4)
    assert layout.sparse_bounds_bytes(int(vpb.sum())) == jlayout.sparse_bounds_bytes(int(vpb.sum()))


def test_bound_scores_equal_jax(tiny_index, tiny_qb, port_index, port_qb):
    for name in ("sb_bounds", "blk_bounds"):
        want = jbounds.bound_scores(getattr(tiny_index, name), tiny_qb.tids, tiny_qb.ws)
        got = bounds.bound_scores(getattr(port_index, name), port_qb.tids, port_qb.ws)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------------ metrics, presets, tree helpers
def test_metrics_equal_jax():
    rng = np.random.default_rng(5)
    pred = rng.integers(0, 50, (64, 10))
    pred[rng.random((64, 10)) < 0.2] = -1
    pred[:6] = -1  # failed queries
    relevant = rng.integers(0, 50, 64)
    for k in (1, 5, 10):
        assert metrics.mrr_at_k(pred, relevant, k) == jmetrics.mrr_at_k(pred, relevant, k)
    assert metrics.failed_queries(pred) == jmetrics.failed_queries(pred) > 0
    assert metrics.partial_queries(pred) == jmetrics.partial_queries(pred) > 0


@pytest.mark.parametrize("k", [10, 100, 1000])
def test_recommended_equals_jax(k):
    got, want = config.recommended(k, "lsp2"), jconfig.recommended(k, "lsp2")
    for f in ("variant", "k", "gamma", "gamma0", "mu", "eta", "beta"):
        assert getattr(got, f) == getattr(want, f), f
    assert api.recommended is config.recommended and "recommended" in api.__all__
    assert config.recommended_static(k, 300) == StaticConfig(**{
        f: getattr(jconfig.recommended_static(k, 300), f) for f in ("variant", "gamma", "gamma0", "k_max")})


def test_tree_helpers_equal_jax():
    rng = np.random.default_rng(2)
    a = {"w": rng.standard_normal((4, 3)).astype(np.float32), "b": (rng.standard_normal(5).astype(np.float32),)}
    b = {"w": rng.standard_normal((4, 3)).astype(np.float32), "b": (rng.standard_normal(5).astype(np.float32),)}
    ta, tb = tree_utils.tree_map(torch.from_numpy, a), tree_utils.tree_map(torch.from_numpy, b)
    ja, jb = {k: jnp.asarray(v) if k == "w" else (jnp.asarray(v[0]),) for k, v in a.items()}, \
        {k: jnp.asarray(v) if k == "w" else (jnp.asarray(v[0]),) for k, v in b.items()}
    for got, want in ((tree_utils.tree_add(ta, tb), jtree.tree_add(ja, jb)),
                      (tree_utils.tree_scale(ta, 0.3), jtree.tree_scale(ja, 0.3)),
                      (tree_utils.tree_zeros_like(ta), jtree.tree_zeros_like(ja))):
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), rtol=1e-6)
        np.testing.assert_allclose(got["b"][0].numpy(), np.asarray(want["b"][0]), rtol=1e-6)
    np.testing.assert_allclose(float(tree_utils.tree_dot(ta, tb)), float(jtree.tree_dot(ja, jb)), rtol=1e-6)


def test_flatten_with_paths_keeps_no_leaf_alive():
    """flatten_with_paths leaves no reference cycle behind: with the garbage
    collector off, a leaf dies with the last reference to its tree, and the
    paths come in the JAX package's order."""
    import gc
    import weakref

    tree = {"b": (torch.ones(2), {"y": torch.ones(1), "x": None}), "a": [torch.zeros(3)]}
    assert list(tree_utils.flatten_with_paths(tree)) == ["a/0", "b/0", "b/1/y"]
    ref = weakref.ref(tree["b"][0])
    enabled = gc.isenabled()
    gc.disable()
    try:
        tree_utils.flatten_with_paths(tree)
        del tree
        assert ref() is None
    finally:
        if enabled:
            gc.enable()
