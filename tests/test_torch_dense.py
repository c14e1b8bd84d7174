"""The port's dense-embedding LSP against the JAX package's, on
tests/test_lsp_dense.py's 8,000 x 32 fixture: the build given the same
candidate order (byte-equal), the carry-across of a JAX-built index, the
port's own k-means by recall, retrieval parity, and the bound properties.

Ids must be equal; scores allclose at rtol=1e-5, atol=1e-5 (float32 dot
products summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import RetrievalConfig as JaxRetrievalConfig
from repro.core.lsp_dense import DenseIndexConfig as JaxDenseIndexConfig
from repro.core.lsp_dense import build_dense_index as jax_build_dense_index
from repro.core.lsp_dense import retrieve_dense as jax_retrieve_dense
from repro.core.lsp_dense import retrieve_dense_exact as jax_retrieve_dense_exact
from repro_torch.core import lsp_dense
from repro_torch.core.config import RetrievalConfig
from repro_torch.core.lsp_dense import (
    DenseIndexConfig,
    _bounds,
    build_dense_index,
    retrieve_dense,
    retrieve_dense_exact,
)
from repro_torch.eval.metrics import recall_vs_oracle
from repro_torch.index.convert import from_dense_arrays

CPU = torch.device("cpu")
BUILD = dict(b=32, c=8, kmeans_iters=3, ns_align=4)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def dense_data():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((16, 32)).astype(np.float32)
    cands = (centers[rng.integers(0, 16, 8000)] + 0.3 * rng.standard_normal((8000, 32))).astype(np.float32)
    q = (centers[rng.integers(0, 16, 6)] + 0.2 * rng.standard_normal((6, 32))).astype(np.float32)
    return cands, q


@pytest.fixture(scope="module")
def jax_index(dense_data):
    return jax_build_dense_index(dense_data[0], JaxDenseIndexConfig(**BUILD))


@pytest.fixture(scope="module")
def port_index(jax_index):
    return from_dense_arrays(jax.tree_util.tree_map(np.asarray, jax_index), CPU)


def _jax_retrieve(jax_index, q, cfg_kw):
    """The JAX package's retrieve_dense, jitted (eager dispatch compiles each op)."""
    return jax.jit(lambda qq: jax_retrieve_dense(jax_index, qq, JaxRetrievalConfig(**cfg_kw)))(jnp.asarray(q))


def _leaves(x, prefix=""):
    """path -> bytes-comparable numpy array or Python scalar, for a dense
    index of either package (bfloat16 as its 16-bit patterns)."""
    out = {}
    for name, v in zip(x._fields, x):
        key = prefix + name
        if hasattr(v, "_fields"):
            out.update(_leaves(v, key + "."))
        elif isinstance(v, int):
            out[key] = v
        elif isinstance(v, torch.Tensor):
            out[key] = (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).numpy()
        else:
            a = np.asarray(v)
            if a.dtype.name == "bfloat16":
                a = a.view(np.int16)
            elif a.dtype == np.uint32:
                a = a.view(np.int32)  # packed words travel as int32 views
            out[key] = a
    return out


def _assert_leaves_equal(port, jax_idx):
    want, got = _leaves(jax_idx), _leaves(port)
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, (key, g.dtype, w.dtype, g.shape, w.shape)
            assert g.tobytes() == w.tobytes(), key
        else:
            assert type(g) is type(w) and g == w, (key, g, w)


def test_build_byte_equal_given_the_jax_order(dense_data, jax_index, monkeypatch):
    order = torch.from_numpy(np.asarray(jax_index.remap)[: jax_index.n_cands].astype(np.int64))
    monkeypatch.setattr(lsp_dense, "dense_order", lambda cands, cfg: order)
    _assert_leaves_equal(build_dense_index(dense_data[0], DenseIndexConfig(**BUILD), device=CPU), jax_index)


def test_from_dense_arrays_carries_every_leaf(port_index, jax_index):
    _assert_leaves_equal(port_index, jax_index)
    assert port_index.cands.dtype == torch.bfloat16


def test_own_kmeans_recall_within_tolerance(dense_data, jax_index):
    """The port's k-means rounds differently, so its candidate order may
    differ; lsp0 recall@10 at a small γ against each package's own exact
    oracle must stay within 0.05 of the JAX build's."""
    cands, q = dense_data
    port = build_dense_index(cands, DenseIndexConfig(**BUILD), device=CPU)
    cfg = dict(variant="lsp0", k=10, gamma=2, gamma0=1)
    r_port = recall_vs_oracle(retrieve_dense(port, q, RetrievalConfig(**cfg))[0].numpy(),
                              retrieve_dense_exact(port, q, 10)[0].numpy())
    r_jax = recall_vs_oracle(np.asarray(_jax_retrieve(jax_index, q, cfg)[0]),
                             np.asarray(jax_retrieve_dense_exact(jax_index, jnp.asarray(q), 10)[0]))
    assert abs(r_port - r_jax) <= 0.05, (r_port, r_jax)


@pytest.mark.parametrize("variant,gamma,gamma0,mu,eta", [
    ("lsp0", 2, 1, 0.5, 1.0), ("lsp0", 8, 2, 0.5, 0.8), ("lsp1", 2, 1, 0.3, 1.0), ("lsp1", 8, 4, 0.6, 1.2),
])
def test_retrieve_dense_matches_jax(dense_data, jax_index, port_index, variant, gamma, gamma0, mu, eta):
    q = dense_data[1]
    kw = dict(variant=variant, k=10, gamma=gamma, gamma0=gamma0, mu=mu, eta=eta)
    want_ids, want_vals = _jax_retrieve(jax_index, q, kw)
    ids, vals = retrieve_dense(port_index, q, RetrievalConfig(**kw))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_vals), **TOL)


@pytest.mark.parametrize("k", [10, 3])
def test_retrieve_dense_exact_matches_jax(dense_data, jax_index, port_index, k):
    q = dense_data[1]
    want_ids, want_vals = jax_retrieve_dense_exact(jax_index, jnp.asarray(q), k)
    ids, vals = retrieve_dense_exact(port_index, q, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_vals), **TOL)


def test_dense_bounds_valid(dense_data, port_index):
    """The superblock bound upper-bounds every true dot product in the superblock."""
    idx, q = port_index, dense_data[1]
    sb_bound = _bounds(idx.sb, torch.from_numpy(q)).numpy()  # [B, NS]
    scores = idx.cands.to(torch.float32).numpy() @ q.T  # [n_pad, B]
    scores[idx.remap.numpy() >= idx.n_cands] = -1e30
    per_sb = scores.reshape(idx.n_superblocks, idx.b * idx.c, -1).max(axis=1).T
    per_sb = np.where(per_sb < -1e29, 0.0, per_sb)
    assert (sb_bound + 1e-2 >= per_sb).all(), (sb_bound - per_sb).min()


def test_dense_exact_at_full_gamma(dense_data, port_index):
    idx, q = port_index, dense_data[1]
    oracle = retrieve_dense_exact(idx, q, 10)[0].numpy()
    ids = retrieve_dense(idx, q, RetrievalConfig(variant="lsp0", k=10, gamma=idx.n_superblocks, gamma0=4))[0]
    assert recall_vs_oracle(ids.numpy(), oracle) == 1.0


def test_dense_entry_points_default_to_the_card(dense_data):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_dense_index(dense_data[0][:100], DenseIndexConfig(**BUILD))
