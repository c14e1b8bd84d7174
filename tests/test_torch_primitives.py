"""The port's query, config and top-k primitives against the JAX package's,
on inputs full of ties (the order statistics must break them the same way)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.query import QueryBatch as JaxQueryBatch
from repro.core.query import prune_terms as jax_prune_terms, scatter_dense as jax_scatter_dense
from repro.core.topk import _canonical_sort_topk, canonical_topk as jax_canonical_topk
from repro_torch.core.config import ConfigError, DynamicParams, StaticConfig, dynamic_args, recommended_static
from repro_torch.core.lsp import competitive_block_topk, masked_kth_min, resolve_block_budget
from repro_torch.core.query import QueryBatch, make_query_batch, prune_terms, scatter_dense
from repro_torch.core.topk import canonical_topk, stable_topk


def _tied(seed, shape, levels=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, levels, shape).astype(np.float32) / 4


@pytest.mark.parametrize("seed,n,k", [(0, 40, 10), (1, 600, 10), (2, 300, 64), (3, 12, 12)])
def test_canonical_topk_matches_jax_on_ties(seed, n, k):
    scores = _tied(seed, (5, n))
    rng = np.random.default_rng(seed + 100)
    ids = rng.permutation(5 * n).reshape(5, n).astype(np.int32)
    ids[:, 1] = ids[:, 0]  # duplicated ids too
    want_v, want_i = jax_canonical_topk(jnp.asarray(scores), jnp.asarray(ids), k, id_bound=5 * n)
    ref_v, ref_i = _canonical_sort_topk(jnp.asarray(scores), jnp.asarray(ids), k)
    got_v, got_i = canonical_topk(torch.from_numpy(scores), torch.from_numpy(ids), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    assert got_i.dtype == torch.int32


@pytest.mark.parametrize("seed,n,k", [(0, 5, 2), (1, 64, 10), (2, 1000, 250), (3, 33, 33)])
def test_stable_topk_ties_like_lax_top_k(seed, n, k):
    x = _tied(seed, (4, n), levels=3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = stable_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_stable_topk_where_torch_topk_differs():
    x = torch.tensor([[1.0, 2.0, 2.0, 2.0, 0.5]])
    assert stable_topk(x, 2)[1].tolist() == [[1, 2]]
    assert jax.lax.top_k(jnp.asarray(x.numpy()), 2)[1].tolist() == [[1, 2]]


def test_scatter_dense_sums_duplicate_terms():
    tids = np.array([[3, 3, 1, 8, 8], [0, 2, 2, 2, 8]], np.int32)  # 8 == vocab: sentinel
    ws = np.array([[0.5, 0.25, 1.0, 0.0, 0.0], [1.5, 0.125, 0.125, 2.0, 7.0]], np.float32)
    want = jax_scatter_dense(JaxQueryBatch(jnp.asarray(tids), jnp.asarray(ws), 8))
    got = scatter_dense(QueryBatch(torch.from_numpy(tids), torch.from_numpy(ws), 8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 3] == 0.75 and got[1, 2] == 2.25 and (got[:, 8] == 0).all()


def test_prune_terms_per_row_beta(tiny_qb):
    tids, ws = np.array(tiny_qb.tids), np.array(tiny_qb.ws)
    beta = np.linspace(0.05, 1.0, tids.shape[0]).astype(np.float32)
    want = jax_prune_terms(tiny_qb, jnp.asarray(beta))
    got = prune_terms(QueryBatch(torch.from_numpy(tids), torch.from_numpy(ws), tiny_qb.vocab),
                      torch.from_numpy(beta))
    np.testing.assert_array_equal(got.tids.numpy(), np.asarray(want.tids))
    np.testing.assert_array_equal(got.ws.numpy(), np.asarray(want.ws))


def test_make_query_batch_matches(tiny_corpus, tiny_qb):
    _, corpus, queries = tiny_corpus
    qb = make_query_batch(queries, corpus.vocab, device="cpu")
    np.testing.assert_array_equal(qb.tids.numpy(), np.asarray(tiny_qb.tids))
    np.testing.assert_array_equal(qb.ws.numpy(), np.asarray(tiny_qb.ws))


def test_masked_kth_min_and_competitive_cut():
    vals = torch.tensor([[5.0, 4.0, 3.0, 1.0], [2.0, 2.0, -1.0, -3.0]])
    assert masked_kth_min(vals, torch.tensor([3, 4])).tolist() == [3.0, 0.0]
    bounds = torch.tensor([[1.0, 3.0, 3.0, -1e30, 3.0]])
    gids = torch.tensor([[9, 7, 4, 2, 5]])
    b, ids, mask = competitive_block_topk(bounds, gids, 4)
    assert ids.tolist() == [[4, 5, 7, 9]] and mask.all()
    b, ids, mask = competitive_block_topk(bounds, gids, 5)
    assert ids[0, 4] == 0 and not mask[0, 4]


def test_config_validation_and_dynamic_args():
    with pytest.raises(ConfigError):
        StaticConfig(gamma=4, gamma0=8)
    with pytest.raises(ConfigError):
        DynamicParams(beta=0.0)
    with pytest.raises(ConfigError):
        DynamicParams(k=20).validate_for(StaticConfig(k_max=10))
    assert recommended_static(10, 64) == StaticConfig(gamma=64, gamma0=32, k_max=10)
    assert resolve_block_budget(StaticConfig(block_budget=500), 320) == 320
    d = dynamic_args([DynamicParams(k=3, mu=0.25), DynamicParams(k=7, beta=1.0)], 2, 10, "cpu")
    assert d.k.tolist() == [3, 7] and d.k.dtype == torch.int32
    assert d.mu.tolist() == [0.25, 0.5] and d.beta.dtype == torch.float32
    with pytest.raises(ValueError):
        dynamic_args([DynamicParams()], 2, 10, "cpu")


@pytest.mark.parametrize("static_kw,dyn_kw", [
    (dict(variant="lsp0", gamma=123, gamma0=4, k_max=10), dict(k=10)),
    (dict(variant="lsp1", gamma=8, gamma0=2, k_max=20, block_budget=7, doc_layout="flat"),
     dict(k=5, mu=0.3, eta=0.9)),
])
def test_combine_matches_jax(static_kw, dyn_kw):
    from repro.core.config import DynamicParams as JaxDynamicParams, StaticConfig as JaxStaticConfig
    from repro.core.config import combine as jax_combine
    from repro_torch.core.config import RetrievalConfig, combine

    got = combine(StaticConfig(**static_kw), DynamicParams(**dyn_kw))
    want = jax_combine(JaxStaticConfig(**static_kw), JaxDynamicParams(**dyn_kw))
    for field in RetrievalConfig.__dataclass_fields__:
        assert getattr(got, field) == getattr(want, field), field
    assert got.resolved_sb_budget() == want.resolved_sb_budget()
    assert got.split() == (StaticConfig(**dict(static_kw, k_max=dyn_kw["k"])), DynamicParams(**dyn_kw))
    with pytest.raises(ConfigError):
        combine(StaticConfig(**static_kw), DynamicParams(k=static_kw["k_max"] + 1))
