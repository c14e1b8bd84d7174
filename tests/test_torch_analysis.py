"""The port's analysis, eval and data modules against the JAX package's.

``data/pipeline.py`` and ``data/graph.py`` must give the same arrays byte for
byte (resume relies on the pipeline's); ``core/gamma_analysis.py`` and
``eval/model_flops.py`` the same floats (the same float64 arithmetic);
``configs/base.py`` the same dataclasses. ``core/threshold.py`` is held at
JAX's sampled positions (the port cannot reproduce ``jax.random.choice``),
scores within rtol 1e-5, atol 1e-6 (float32 sums in another order); its own
sampler to its contract.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_arch_names as jax_all_arch_names, get_arch as jax_get_arch
from repro.core import gamma_analysis as jga
from repro.core.query import QueryBatch as JaxQueryBatch
from repro.core.threshold import estimate_theta as jax_estimate_theta
from repro.data import graph as jgraph
from repro.data import pipeline as jpipe
from repro.eval import model_flops as jmf
from repro_torch.configs.base import ArchConfig, GNNCfg, LMCfg, MoECfg, RecsysCfg, all_arch_names, get_arch
from repro_torch.core import gamma_analysis as ga
from repro_torch.core.query import make_query_batch
from repro_torch.core.threshold import estimate_theta, sample_positions, theta_at_positions
from repro_torch.data import graph
from repro_torch.data import pipeline as pipe
from repro_torch.eval import model_flops as mf
from repro_torch.index.convert import from_arrays

TOL = dict(rtol=1e-5, atol=1e-6)
ARCHS = jax_all_arch_names()


def _port_arch(jarch) -> ArchConfig:
    """The JAX package's ArchConfig as the port's, through ``dataclasses.asdict``."""
    d = dataclasses.asdict(jarch)
    lm = d["lm"] and LMCfg(**{**d["lm"], "moe": d["lm"]["moe"] and MoECfg(**d["lm"]["moe"])})
    return ArchConfig(**{**d, "lm": lm, "gnn": d["gnn"] and GNNCfg(**d["gnn"]),
                         "recsys": d["recsys"] and RecsysCfg(**d["recsys"])})


def _same_bytes(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


# ------------------------------------------------------------------ configs and model FLOPs
@pytest.mark.parametrize("name", ARCHS)
def test_arch_configs_and_reduced_equal_jax(name):
    jarch = jax_get_arch(name)
    arch = _port_arch(jarch)
    assert dataclasses.asdict(arch.reduced()) == dataclasses.asdict(jarch.reduced())
    assert {k: dataclasses.asdict(v) for k, v in arch.runnable_shapes().items()} == \
        {k: dataclasses.asdict(v) for k, v in jarch.runnable_shapes().items()}


@pytest.mark.parametrize("name", ARCHS)
def test_model_flops_equal_jax_for_every_runnable_shape(name):
    jarch = jax_get_arch(name)
    arch = _port_arch(jarch)
    assert arch.runnable_shapes()
    for shape_name, shape in arch.runnable_shapes().items():
        want = jmf.model_flops(jarch, shape_name)
        assert mf.model_flops(arch, shape_name) == want, shape_name
        family = {"lm": lambda: mf.lm_flops(arch.lm, shape), "recsys": lambda: mf.recsys_flops(arch, shape),
                  "gnn": lambda: mf.gnn_flops(arch, shape)}[arch.family]
        assert family() == want and want > 0, shape_name
    if arch.family == "lm":
        assert mf.lm_active_params(arch.lm) == jmf.lm_active_params(jarch.lm)
        assert mf.lm_total_params(arch.lm) == jmf.lm_total_params(jarch.lm)


@pytest.mark.parametrize("name", ARCHS)
def test_arch_registry_equals_jax(name):
    assert all_arch_names() == ARCHS and len(ARCHS) == 10
    arch = get_arch(name)
    assert type(arch) is ArchConfig
    assert dataclasses.asdict(arch) == dataclasses.asdict(jax_get_arch(name))
    assert arch == _port_arch(jax_get_arch(name))


# ------------------------------------------------------------------ data
BATCH_FNS = {
    "splade": (pipe.splade_synthetic_batch(256, 8, 8, 12), jpipe.splade_synthetic_batch(256, 8, 8, 12)),
    "lm": (pipe.lm_synthetic_batch(64, 4, 16), jpipe.lm_synthetic_batch(64, 4, 16)),
}


@pytest.mark.parametrize("kind", list(BATCH_FNS))
def test_pipeline_batches_are_byte_equal(kind):
    fn, jfn = BATCH_FNS[kind]
    for seed in (0, 5):
        port = pipe.CounterPipeline(pipe.PipelineConfig(global_batch=8, seed=seed), fn)
        ref = jpipe.CounterPipeline(jpipe.PipelineConfig(global_batch=8, seed=seed), jfn)
        for step in (0, 1, 17):
            got, want = port.batch_at(step), ref.batch_at(step)
            assert list(got) == list(want)
            for k in got:
                _same_bytes(got[k], want[k], f"{kind} seed {seed} step {step} {k}")
        it, jit_ = port.iterate(start_step=3), ref.iterate(start_step=3)
        try:
            for i in range(4):
                got, want = next(it), next(jit_)
                for k in got:
                    _same_bytes(got[k], want[k], f"{kind} iterate from 3, batch {i} {k}")
        finally:
            it.close()
            jit_.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_graph_and_subgraph_sampler_equal_jax(seed):
    g = graph.make_random_graph(600, 5000, 12, n_classes=5, seed=seed)
    jg = jgraph.make_random_graph(600, 5000, 12, n_classes=5, seed=seed)
    for f in g._fields:
        _same_bytes(getattr(g, f), getattr(jg, f), f"graph {f}")
    seeds = np.random.default_rng(seed).choice(600, 32, replace=False)
    sub = graph.sample_subgraph(g, seeds, (5, 3), np.random.default_rng(seed + 10))
    jsub = jgraph.sample_subgraph(jg, seeds, (5, 3), np.random.default_rng(seed + 10))
    for f in sub._fields:
        _same_bytes(getattr(sub, f), getattr(jsub, f), f"subgraph {f}")
    assert graph.SampledSubgraph.shapes(32, (5, 3), 12) == jgraph.SampledSubgraph.shapes(32, (5, 3), 12)


# ------------------------------------------------------------------ γ analysis
def test_gamma_analysis_equals_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 300, 200)
    b = rng.uniform(0.5, 50, 200)
    x = np.concatenate([[0.0, 1.0, 1e-12, 1 - 1e-12], rng.uniform(0, 1, 196)])
    np.testing.assert_array_equal(ga.betainc(a, b, x), jga.betainc(a, b, x))
    f = np.sort(rng.uniform(0, 1, 64))
    for gamma, n in [(1, 8), (8, 512), (250, 8192)]:
        np.testing.assert_array_equal(ga.order_stat_cdf(gamma, n, f), jga.order_stat_cdf(gamma, n, f))
    sbmax = rng.gamma(2.0, 1.0, (24, 96)) * (rng.uniform(size=(24, 96)) < 0.7)
    edges, cdf, ratios = ga.sbmax_ratio_distribution(sbmax, n_bins=32)
    for got, want in zip((edges, cdf, ratios), jga.sbmax_ratio_distribution(sbmax, n_bins=32)):
        np.testing.assert_array_equal(got, want)
    contains = rng.uniform(size=(24, 96)) < 0.1
    p_bin = ga.p_contains_topk_by_bin(ratios, contains, edges)
    np.testing.assert_array_equal(p_bin, jga.p_contains_topk_by_bin(ratios, contains, edges))
    gammas = np.array([1, 4, 16, 96, 200])
    np.testing.assert_array_equal(ga.p_gamma_contains(gammas, 96, edges, cdf, p_bin),
                                  jga.p_gamma_contains(gammas, 96, edges, cdf, p_bin))


def test_contains_topk_equals_jax(tiny_index, oracle):
    ids, _ = oracle
    ids = ids.copy()
    ids[0, -3:] = -1  # padded oracle slots hold no doc
    got = ga.contains_topk(from_arrays(tiny_index, "cpu"), ids)
    want = jga.contains_topk(tiny_index, ids)
    np.testing.assert_array_equal(got, want)
    assert got.any(axis=1).all()


# ------------------------------------------------------------------ threshold estimation
def test_theta_at_jax_positions_equals_estimate_theta(tiny_index, tiny_corpus):
    _, corpus, queries = tiny_corpus
    idx = from_arrays(tiny_index, "cpu")
    qb = make_query_batch(queries, corpus.vocab, device="cpu")
    jqb = JaxQueryBatch(jnp.asarray(qb.tids.numpy()), jnp.asarray(qb.ws.numpy()), corpus.vocab)
    n_pad = tiny_index.doc_remap.shape[0]
    for seed, n_sample in [(0, 512), (3, 4096)]:
        pos = np.array(jax.random.choice(jax.random.PRNGKey(seed), n_pad, (min(n_sample, n_pad),), replace=False))
        for k in (1, 10, 100):
            want = jax_estimate_theta(tiny_index, jqb, k, n_sample=n_sample, seed=seed)
            got = theta_at_positions(idx, qb, k, torch.from_numpy(pos))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"seed {seed} k {k}")
        ks = np.array([(1, 5, 10, 40)[i % 4] for i in range(qb.tids.shape[0])], np.int32)
        want = jax_estimate_theta(tiny_index, jqb, jnp.asarray(ks), n_sample=n_sample, seed=seed, k_max=40)
        got = theta_at_positions(idx, qb, torch.from_numpy(ks), torch.from_numpy(pos), k_max=40)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"seed {seed} tensor k")


def test_sampler_contract(tiny_index, tiny_corpus):
    n_pad = 3000
    a = sample_positions(n_pad, 1024, seed=7)
    assert a.shape == (1024,) and len(torch.unique(a)) == 1024
    assert int(a.min()) >= 0 and int(a.max()) < n_pad
    assert torch.equal(a, sample_positions(n_pad, 1024, seed=7))
    assert not torch.equal(a, sample_positions(n_pad, 1024, seed=8))
    assert torch.equal(torch.sort(sample_positions(100, 1024)).values, torch.arange(100))
    _, corpus, queries = tiny_corpus
    idx = from_arrays(tiny_index, "cpu")
    qb = make_query_batch(queries, corpus.vocab, device="cpu")
    pos = sample_positions(idx.doc_remap.shape[0], 256, seed=2)
    torch.testing.assert_close(estimate_theta(idx, qb, 10, n_sample=256, seed=2), theta_at_positions(idx, qb, 10, pos),
                               rtol=0, atol=0)
