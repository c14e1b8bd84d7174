"""Traversal parity: the port's search_retrieve against the JAX package's
(impl="ref") on the same index and queries, for every variant at several
dynamic points, a mixed per-row batch, a binding block budget and the flat
document layout.

Doc ids, θ-driven visit counters must be equal; scores and θ allclose at
rtol=1e-5, atol=1e-5 (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

from repro.core import jit_search as jax_jit_search
from repro.core.config import DynamicParams as JaxDynamicParams, StaticConfig as JaxStaticConfig
from repro.core.exact import retrieve_exact as jax_retrieve_exact
from repro_torch.core import ops
from repro_torch.core.config import ConfigError, DynamicParams, StaticConfig
from repro_torch.core.exact import retrieve_exact
from repro_torch.core.lsp import search_retrieve
from repro_torch.core.query import QueryBatch
from repro_torch.index.convert import from_arrays

TOL = dict(rtol=1e-5, atol=1e-5)

CASES = {
    "lsp0": (dict(variant="lsp0", gamma=8, gamma0=2), [dict(), dict(k=5, beta=0.5, eta=0.8)]),
    "lsp1": (dict(variant="lsp1", gamma=8, gamma0=4), [dict(mu=0.3, beta=0.5), dict(k=7, mu=0.6, eta=1.2, beta=1.0)]),
    "lsp2": (dict(variant="lsp2", gamma=8, gamma0=4), [dict(mu=0.3, eta=0.8), dict(beta=1.0, eta=0.6)]),
    "sp": (dict(variant="sp", gamma=16, gamma0=4), [dict(mu=0.1, eta=0.5, beta=1.0), dict(k=10, mu=0.5)]),
    "bmp": (dict(variant="bmp", gamma=16, gamma0=4), [dict(beta=0.5), dict(k=4, eta=0.7, beta=1.0)]),
    "lsp0_block_budget": (dict(variant="lsp0", gamma=32, gamma0=4, block_budget=16), [dict(beta=0.5), dict(eta=0.9)]),
    "bmp_block_budget": (dict(variant="bmp", gamma=16, gamma0=4, block_budget=40), [dict(beta=0.5)]),
}


def _mixed_rows(q):
    """One DynamicParams per row, cycling through k, μ, η and β."""
    return [dict(k=1 + (i * 3) % 10, mu=(0.2, 0.5, 0.9)[i % 3], eta=(0.7, 1.0)[i % 2],
                 beta=(0.33, 0.6, 1.0)[i % 3]) for i in range(q)]


@pytest.fixture(scope="module")
def jax_runner(tiny_index):
    """The JAX traversal compiled once per static config (impl="ref")."""
    runners = {}

    def get(scfg_kw):
        key = tuple(sorted(scfg_kw.items()))
        if key not in runners:
            runners[key] = jax_jit_search(tiny_index, JaxStaticConfig(**scfg_kw), impl="ref")
        return runners[key]

    return get


@pytest.fixture(scope="module")
def port_index(tiny_index):
    return from_arrays(tiny_index, torch.device("cpu"))


@pytest.fixture(scope="module")
def port_qb(tiny_qb):
    return QueryBatch(torch.from_numpy(np.array(tiny_qb.tids)), torch.from_numpy(np.array(tiny_qb.ws)),
                      tiny_qb.vocab)


def _assert_same(got, want):
    np.testing.assert_array_equal(got.doc_ids.numpy(), np.asarray(want.doc_ids))
    np.testing.assert_array_equal(got.n_superblocks_visited.numpy(), np.asarray(want.n_superblocks_visited))
    np.testing.assert_array_equal(got.n_blocks_scored.numpy(), np.asarray(want.n_blocks_scored))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), **TOL)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta), **TOL)


def _run_both(jax_runner, tiny_qb, port_index, port_qb, scfg_kw, dyn_kw):
    jrun = jax_runner(scfg_kw)
    if isinstance(dyn_kw, list):
        want = jrun(tiny_qb, [JaxDynamicParams(**d) for d in dyn_kw])
        dyn = [DynamicParams(**d) for d in dyn_kw]
    else:
        want = jrun(tiny_qb, JaxDynamicParams(**dyn_kw))
        dyn = DynamicParams(**dyn_kw)
    _assert_same(search_retrieve(port_index, port_qb, StaticConfig(**scfg_kw), dyn), want)
    return want


@pytest.mark.parametrize("case,point", [(c, i) for c, (_, pts) in CASES.items() for i in range(len(pts))])
def test_search_retrieve_matches_jax(jax_runner, tiny_qb, port_index, port_qb, case, point):
    scfg_kw, points = CASES[case]
    want = _run_both(jax_runner, tiny_qb, port_index, port_qb, scfg_kw, points[point])
    assert (np.asarray(want.doc_ids) >= 0).any()  # the case retrieves something


@pytest.mark.parametrize("case,point", [(c, i) for c in ("lsp0", "lsp1", "bmp") for i in range(len(CASES[c][1]))])
def test_flat_layout_matches_jax(jax_runner, tiny_qb, port_index, port_qb, case, point):
    """Round 0 and phase 3 score from the flat operand (doc_score_flat)."""
    scfg_kw, points = CASES[case]
    _run_both(jax_runner, tiny_qb, port_index, port_qb, dict(scfg_kw, doc_layout="flat"), points[point])


def test_flat_layout_without_its_operand_raises(port_index, port_qb):
    no_flat = port_index._replace(docs_flatq=None)
    qdense = torch.zeros((1, port_index.vocab + 1))
    with pytest.raises(ConfigError, match="flat"):
        ops.score_gather(no_flat, qdense, torch.zeros((1, 2), dtype=torch.int32), torch.ones((1, 2), dtype=torch.bool),
                         "flat")
    with pytest.raises(ConfigError, match="flat"):
        search_retrieve(no_flat, port_qb, StaticConfig(gamma=8, gamma0=2, doc_layout="flat"))
    with pytest.raises(ConfigError, match="doc_layout"):
        StaticConfig(doc_layout="csr")


@pytest.mark.parametrize("case", ["lsp1", "lsp2", "bmp"])
def test_mixed_per_row_params_match_jax(jax_runner, tiny_qb, port_index, port_qb, case):
    scfg_kw, _ = CASES[case]
    _run_both(jax_runner, tiny_qb, port_index, port_qb, scfg_kw, _mixed_rows(tiny_qb.tids.shape[0]))


@pytest.mark.parametrize("k", [10, 3])
def test_retrieve_exact_matches_jax(tiny_index, tiny_qb, port_index, port_qb, k):
    want_ids, want_vals = jax_retrieve_exact(tiny_index, tiny_qb, k, doc_chunk=512)
    ids, vals = retrieve_exact(port_index, port_qb, k, doc_chunk=700)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_vals), **TOL)


def test_kernel_impl_refuses_cpu(port_index, port_qb):
    with pytest.raises(ValueError, match="CUDA"):
        search_retrieve(port_index, port_qb, StaticConfig(gamma=8, gamma0=2), impl="kernel")
