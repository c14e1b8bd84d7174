"""The process-group transports of the sharded paths, on gloo worlds of 2 and
3 ranks (the 3-rank world cuts the 32-superblock tiny index raggedly).

Each world is spawned once (``torch_mesh_worker.spawn_world``: a file store,
a wait that runs from the last report of any rank, an ordered teardown) and
runs every case on every rank:
  * the process-group ``ShardedRetriever`` (each rank loading only its shard
    from a set the JAX package saved, and each rank cutting its own shard of
    the index) equal to the host loop on all nine result fields, on every
    rank; the facade's ``Retriever.load(..., group=)`` resolves to it;
  * ``distributed_topk`` equal to one canonical top-k over the whole row,
    ties across ranks included, and ``pmax_scalar``;
  * ``make_mesh_retriever`` against the JAX package's ``retrieve_distributed``;
  * sharded dense LSP through the group, equal to the host loop;
  * the serving launcher's job (``launch/serve.py``) with rank 0's engine
    driving every rank through the group front end (``serve/group.py``),
    across a swap mid-run and a k sweep, equal to the same job through the
    host loop; and a follower that goes silent after the opening, which
    fails every pending request of rank 0's engine with ``ShardGroupError``.
The host loop of sharded dense is held here too, without a world: its ids
equal JAX's ``shard_dense_index`` shards run one by one through JAX's
``retrieve_dense`` and merged canonically, and its recall@10 against the
single-device path is at least 0.9 (the JAX package's bar).

Tolerance: ids, θ, counters and telemetry equal; scores within rtol 1e-5,
atol 1e-5 against JAX (float32 sums in another order); the port's two
transports run the same arithmetic on the same device, so equal bits.
"""

import jax
import numpy as np
import pytest
import torch
from torch_mesh_worker import spawn_world

from repro.core.config import RetrievalConfig as JaxRetrievalConfig
from repro.core.lsp_dense import (
    DenseIndexConfig as JaxDenseIndexConfig,
    build_dense_index as jax_build_dense_index,
    retrieve_dense as jax_retrieve_dense,
    shard_dense_index as jax_shard_dense_index,
)
from repro.core.query import make_query_batch as jax_make_query_batch
from repro.core.topk import canonical_topk as jax_canonical_topk
from repro.distributed.retrieval import retrieve_distributed as jax_retrieve_distributed
from repro.distributed.retrieval import shard_index as jax_shard_index
from repro.index import store as jax_store
from repro_torch.core.config import DynamicParams, RetrievalConfig, StaticConfig
from repro_torch.core.lsp_dense import make_sharded_dense_retriever, retrieve_dense, shard_dense_index
from repro_torch.core.query import make_query_batch
from repro_torch.core.topk import canonical_topk
from repro_torch.distributed.sharded import sharded_retrieve
from repro_torch.eval.metrics import recall_vs_oracle
from repro_torch.index.convert import from_arrays, from_dense_arrays

TOL = dict(rtol=1e-5, atol=1e-5)
WORLDS = [2, 3]
CONFIGS = [
    ("lsp0", dict(variant="lsp0", gamma=8, gamma0=2), None),
    ("lsp2_mixed_rows", dict(variant="lsp2", gamma=8, gamma0=4),
     [dict(k=1 + (i * 3) % 10, mu=(0.2, 0.5, 0.9)[i % 3], eta=(0.7, 1.0)[i % 2]) for i in range(16)]),
    ("lsp1_block_budget", dict(variant="lsp1", gamma=16, gamma0=4, block_budget=12), [dict(k=10, mu=0.5)] * 16),
]
MESH_CFG = dict(variant="lsp0", k=10, gamma=8, gamma0=2, beta=0.5)
# the serving launcher's job under the world: 8 superblocks cut raggedly into 3
LAUNCH_ARGV = ["--n-docs", "1024", "--vocab", "256", "--requests", "8", "--max-batch", "4", "--swap-mid-run",
               "--sweep-k", "1,5", "--device", "cpu"]


def _dense_cfg(n: int) -> dict:
    """Each of n shards of the 18-superblock dense index visits all of its
    superblocks at most (the JAX package's sharded dense test)."""
    return dict(variant="lsp0", k=10, gamma=18 // n, gamma0=2)


@pytest.fixture(scope="module")
def dense():
    """A JAX dense index of 4,096 clustered 16-dim candidates (18 superblocks,
    ns_align 6: cuts evenly into 2 and 3) carried into the port, and 6 rows."""
    rng = np.random.default_rng(0)
    centres = rng.standard_normal((8, 16)).astype(np.float32)
    cands = (centres[rng.integers(0, 8, 4096)] + 0.3 * rng.standard_normal((4096, 16))).astype(np.float32)
    jidx = jax_build_dense_index(cands, JaxDenseIndexConfig(b=32, c=8, kmeans_iters=2, ns_align=6))
    q = rng.standard_normal((6, 16)).astype(np.float32)
    return jidx, from_dense_arrays(jax.tree_util.tree_map(np.asarray, jidx), "cpu"), q


@pytest.fixture(scope="module", params=WORLDS, ids=lambda p: f"{p}-ranks")
def world(request, tiny_index, tiny_corpus, dense, tmp_path_factory):
    """One spawned gloo world of P ranks, every case run once; returns
    (P, {rank: results}, the spec)."""
    n = request.param
    _, corpus, queries = tiny_corpus
    root = tmp_path_factory.mktemp(f"world{n}")
    jax_store.save_index(str(root / "single"), tiny_index)
    jax_store.save_sharded_index(str(root / "sharded"), tiny_index, n)
    _, didx, q = dense
    torch.save(shard_dense_index(didx, n), str(root / "dense.pt"))
    rng = np.random.default_rng(n)
    levels = np.array([0.5, 1.0, 2.0, 3.0], np.float32)
    spec = dict(
        vocab=corpus.vocab,
        queries=[(np.asarray(t), np.asarray(w)) for t, w in queries],
        index_dir=str(root / "single"),
        sharded_dir=str(root / "sharded"),
        configs=CONFIGS,
        topk_scores=levels[rng.integers(0, 4, (5, 12 * n))],  # ties everywhere, across ranks too
        topk_k=7,
        mesh_cfg=MESH_CFG,
        dense_shards=str(root / "dense.pt"),
        dense_cfg=_dense_cfg(n),
        dense_q=q,
        launch_argv=LAUNCH_ARGV,
    )
    (root / "world").mkdir()
    return n, spawn_world(n, spec, str(root / "world")), spec


def _port_index(tiny_index):
    return from_arrays(tiny_index, "cpu")


def _assert_equal_fields(got: dict, want, ctx: str):
    for f in want._fields:
        np.testing.assert_array_equal(got[f], getattr(want, f).numpy(), err_msg=f"{ctx}: {f}")


@pytest.mark.parametrize("case", [c[0] for c in CONFIGS])
def test_group_transport_equals_the_host_loop(world, tiny_index, case):
    n, ranks, spec = world
    _, scfg_kw, dyn = next(c for c in CONFIGS if c[0] == case)
    from repro_torch.distributed.retrieval import shard_index

    qb = make_query_batch(spec["queries"], spec["vocab"], device="cpu")
    index = _port_index(tiny_index)
    want = sharded_retrieve(shard_index(index, n), qb, StaticConfig(**scfg_kw), impl="ref",
                            ns_true=index.n_superblocks, dyn=None if dyn is None else [DynamicParams(**d) for d in dyn])
    assert sorted(ranks) == list(range(n))
    for rank, res in ranks.items():
        _assert_equal_fields(res[f"dir/{case}"], want, f"rank {rank}, own shard from the saved set")
        _assert_equal_fields(res[f"cut/{case}"], want, f"rank {rank}, own shard cut from the index")
    assert want.shard_theta.shape == (len(spec["queries"]), n)


def test_group_facade_serves_a_shard_set(world, tiny_index):
    from repro_torch.api import Retriever, SearchRequest

    n, ranks, spec = world
    host = Retriever.load(spec["sharded_dir"], StaticConfig(**CONFIGS[0][1]), impl="ref", device="cpu")
    assert host.backend_name == "sharded"
    want = host.search_batch([SearchRequest(t, w) for t, w in spec["queries"]])
    for rank, res in ranks.items():
        got = res["facade"]
        assert got["backend"] == "shard_map"
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got["doc_ids"][i], w.doc_ids, err_msg=f"rank {rank} query {i}")
            assert got["theta"][i] == w.theta
            np.testing.assert_array_equal(got["shard_candidates"][i], w.shard_candidates)
            assert w.shard_candidates.shape == (n,)


def test_distributed_topk_equals_one_canonical_topk(world):
    n, ranks, spec = world
    scores = torch.from_numpy(spec["topk_scores"])
    ids = torch.arange(scores.shape[1], dtype=torch.int32).expand_as(scores)
    vals, want_ids = canonical_topk(scores, ids, spec["topk_k"])
    jvals, jids = jax_canonical_topk(spec["topk_scores"], np.asarray(ids), spec["topk_k"])
    np.testing.assert_array_equal(want_ids.numpy(), np.asarray(jids))
    for rank, res in ranks.items():
        np.testing.assert_array_equal(res["topk"][0], vals.numpy(), err_msg=f"rank {rank}")
        np.testing.assert_array_equal(res["topk"][1], want_ids.numpy(), err_msg=f"rank {rank}")
        np.testing.assert_array_equal(res["pmax"], [n - 1, 0])


def test_mesh_retriever_equals_jax_retrieve_distributed(world, tiny_index, tiny_corpus):
    n, ranks, spec = world
    jqb = jax_make_query_batch(spec["queries"], spec["vocab"])
    j_ids, j_scores = jax_retrieve_distributed(jax_shard_index(tiny_index, n), jqb, JaxRetrievalConfig(**MESH_CFG),
                                               impl="ref")
    for rank, res in ranks.items():
        ids, scores = res["mesh"]
        np.testing.assert_array_equal(ids, np.asarray(j_ids), err_msg=f"rank {rank}")
        np.testing.assert_allclose(scores, np.asarray(j_scores), **TOL)


def test_sharded_dense_group_equals_the_host_loop(world, dense):
    n, ranks, spec = world
    _, didx, q = dense
    run = make_sharded_dense_retriever(shard_dense_index(didx, n), RetrievalConfig(**_dense_cfg(n)), impl="ref")
    ids, vals = run(torch.from_numpy(q))
    for rank, res in ranks.items():
        np.testing.assert_array_equal(res["dense"][0], ids.numpy(), err_msg=f"rank {rank}")
        np.testing.assert_array_equal(res["dense"][1], vals.numpy(), err_msg=f"rank {rank}")


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_dense_host_loop_equals_jax_shard_by_shard(dense, n):
    """What ``dense_local_fn`` does per shard, with no mesh: JAX's shards
    through JAX's ``retrieve_dense``, merged canonically."""
    jidx, didx, q = dense
    jshards = jax_shard_dense_index(jidx, n)
    shards = shard_dense_index(didx, n)
    for js, s in zip(jshards, shards):  # the cut is the JAX package's, word for word
        want = from_dense_arrays(jax.tree_util.tree_map(np.asarray, js), "cpu")
        for part in ("sb", "blk"):
            for field in ("max_packed", "min_packed"):
                assert torch.equal(getattr(getattr(s, part), field), getattr(getattr(want, part), field))
        assert torch.equal(s.remap, want.remap)
    cfg = JaxRetrievalConfig(**_dense_cfg(n))
    parts = [jax_retrieve_dense(js, q, cfg) for js in jshards]
    j_ids = np.concatenate([np.asarray(p[0]) for p in parts], axis=1)
    j_vals = np.concatenate([np.where(np.asarray(p[0]) >= 0, np.asarray(p[1]), -1e30) for p in parts], axis=1)
    mv, mi = jax_canonical_topk(j_vals, j_ids, cfg.k)
    want_ids = np.where(np.asarray(mv) > -1e30 / 2, np.asarray(mi), -1)
    ids, vals = make_sharded_dense_retriever(shards, RetrievalConfig(**_dense_cfg(n)))(q)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(vals.numpy(), np.asarray(mv), **TOL)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_dense_recall_against_single(dense, n):
    _, didx, q = dense
    single, _ = retrieve_dense(didx, q, RetrievalConfig(variant="lsp0", k=10, gamma=didx.n_superblocks // 2,
                                                        gamma0=2))
    ids, _ = make_sharded_dense_retriever(shard_dense_index(didx, n), RetrievalConfig(**_dense_cfg(n)))(q)
    assert recall_vs_oracle(ids.numpy(), single.numpy()) >= 0.9


def test_shard_count_must_divide_the_dense_superblocks(dense):
    _, didx, _ = dense
    with pytest.raises(ValueError, match="equal shards"):
        shard_dense_index(didx, 4)


def test_launcher_front_end_equals_the_host_loop(world):
    """``launch/serve.py`` under the world: rank 0's engine drives every rank
    through the group front end, across a swap mid-run and a k sweep, and
    every response equals the same job's through the host loop in one
    process on every field of the result and on the point served. Which
    epoch served a request of the first half depends on when the swap
    flipped; every request of the second half came after it."""
    import contextlib
    import io

    from repro_torch.launch.serve import parse_args, serve_job

    n, ranks, spec = world
    got = ranks[0]["launcher"]
    assert all(ranks[r]["launcher"] is None for r in range(1, n))  # the followers return nothing
    with contextlib.redirect_stdout(io.StringIO()):
        want = serve_job(parse_args(LAUNCH_ARGV + ["--shards", str(n)]))
    assert "shard_map transport" in got["printed"] and "backend shard_map" in got["printed"]
    assert got["summary"] == {"requests": 8 + 16, "swaps": 1, "failures": 0} and got["recompiles"] == 0
    for name in ("responses", "sweep"):
        wants = [r for r in getattr(want, name)]
        assert len(got[name]) == len(wants) == (8 if name == "responses" else 16)
        for i, (g, w) in enumerate(zip(got[name], wants)):
            for f, v in g.items():
                if f != "epoch":
                    np.testing.assert_array_equal(v, getattr(w, f), err_msg=f"{name} {i}: {f}")
    assert [r["epoch"] for r in got["responses"][4:]] == [1] * 4  # the second half ran on the swapped-in set


def test_a_dead_follower_fails_the_pending_requests_with_a_typed_error(world):
    n, ranks, _ = world
    got = ranks[0]["dead_follower"]
    assert got == {"outcomes": ["ShardGroupError"] * 9, "failures": 9}
    assert ranks[1]["dead_follower"] == "open"  # it took part in the opening, then went silent
    assert all(ranks[r]["dead_follower"] == "RuntimeError" for r in range(2, n))
