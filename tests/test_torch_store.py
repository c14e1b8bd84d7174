"""The port's index store against the JAX package's: a directory saved by
either package loads in the other, with every leaf equal, the same
fingerprint and the same manifest bytes; the manifest codec writes what
``msgpack.packb`` writes; a bad directory raises what JAX raises."""

import os

import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.index import store as jax_store
from repro.index.builder import IndexBuildConfig as JaxIndexBuildConfig
from repro_torch.api import Retriever, SearchRequest, StaticConfig
from repro_torch.ckpt.checkpoint import COMMIT_MARKER
from repro_torch.index import _msgpack, store
from repro_torch.index.builder import IndexBuildConfig
from repro_torch.index.convert import from_arrays
from repro_torch.index.layout import LAYOUT_VERSION, LSPIndex

BUILD = dict(b=8, c=8, kmeans_iters=3)


def _assert_leaves_equal(got, want, path="index"):
    """Two port indexes: equal tensors (dtype too), equal scalars of one type, None alike."""
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype, path
        assert torch.equal(got, want), path
    elif isinstance(want, tuple):
        assert type(got) is type(want), path
        for f in want._fields:
            _assert_leaves_equal(getattr(got, f), getattr(want, f), f"{path}.{f}")
    else:
        assert got == want and type(got) is type(want), path


def _files(directory):
    return {f: open(os.path.join(directory, f), "rb").read() for f in sorted(os.listdir(directory))}


@pytest.fixture(scope="module")
def saved(tiny_index, tmp_path_factory):
    """The tiny index saved by JAX and by the port, at the same build config."""
    root = tmp_path_factory.mktemp("store")
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    jax_fp = jax_store.save_index(jax_dir, tiny_index, JaxIndexBuildConfig(**BUILD))
    port_fp = store.save_index(port_dir, from_arrays(tiny_index, "cpu"), IndexBuildConfig(**BUILD))
    return jax_dir, jax_fp, port_dir, port_fp


@pytest.mark.parametrize("mmap", [True, False])
def test_jax_saved_index_loads_into_the_port(saved, mmap):
    jax_dir, jax_fp, _, _ = saved
    got = store.load_index(jax_dir, mmap=mmap, verify=True, device="cpu")
    want = from_arrays(jax_store.load_index(jax_dir, device=False), "cpu")
    _assert_leaves_equal(got, want)
    assert store.read_manifest(jax_dir)["fingerprint"] == jax_fp
    assert store.build_config_of(jax_dir) == IndexBuildConfig(**BUILD)
    assert store.manifest_format(jax_dir) == store.MANIFEST_FORMAT


def test_port_saved_index_loads_into_jax_with_the_same_bytes(saved):
    jax_dir, jax_fp, port_dir, port_fp = saved
    assert port_fp == jax_fp
    assert _files(port_dir) == _files(jax_dir)  # the manifest and every .npy, byte for byte
    loaded = jax_store.load_index(port_dir, mmap=False, verify=True, expect_fingerprint=jax_fp)
    assert jax_store.read_manifest(port_dir)["fingerprint"] == port_fp
    assert jax_store.build_config_of(port_dir) == JaxIndexBuildConfig(**BUILD)
    assert np.asarray(loaded.sb_bounds.packed).dtype == np.uint32


def test_port_built_index_round_trips(tiny_corpus, tmp_path):
    _, corpus, queries = tiny_corpus
    scfg = StaticConfig(variant="lsp0", gamma=8, gamma0=2, k_max=10)
    cfg = IndexBuildConfig(b=8, c=8, kmeans_iters=2, quant_granularity="global", doc_bits=16)
    built = Retriever.build(corpus, scfg, build_cfg=cfg, device="cpu")
    fp = built.save(str(tmp_path / "index"))
    loaded = Retriever.load(str(tmp_path / "index"), scfg, device="cpu")
    _assert_leaves_equal(loaded.index, built.index)
    assert isinstance(loaded.index.sb_bounds.scale, float) and loaded.index.docs_fwdq.ws.dtype == torch.uint16
    assert store.build_config_of(str(tmp_path / "index")) == cfg
    assert jax_store.load_index(str(tmp_path / "index"), verify=True, expect_fingerprint=fp) is not None
    requests = [SearchRequest(t, w) for t, w in queries]
    for a, b in zip(loaded.search_batch(requests), built.search_batch(requests)):
        np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
        np.testing.assert_array_equal(a.scores, b.scores)


def test_save_replaces_a_committed_copy_atomically(tiny_index, tmp_path):
    directory = str(tmp_path / "index")
    idx = from_arrays(tiny_index, "cpu")
    store.save_index(directory, idx)
    fp = store.save_index(directory, idx._replace(docs_flat=None))
    assert store.read_manifest(directory)["fingerprint"] == fp
    assert store.load_index(directory, device="cpu").docs_flat is None
    assert not os.path.exists(directory + ".tmp") and not os.path.exists(directory + ".old")


# ---- the manifest codec ---------------------------------------------------------------

_LEAVES = (st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=300) | st.binary(max_size=300))
_VALUES = st.recursive(_LEAVES, lambda inner: st.lists(inner, max_size=20)
                       | st.dictionaries(st.text(max_size=10) | st.integers(-5, 300), inner, max_size=20),
                       max_leaves=60)


def test_codec_writes_and_reads_the_manifests(saved):
    jax_dir, _, port_dir, _ = saved
    for directory in (jax_dir, port_dir):
        raw = open(os.path.join(directory, store.MANIFEST_NAME), "rb").read()
        manifest = msgpack.unpackb(raw, strict_map_key=False)
        assert _msgpack.unpackb(raw) == manifest
        assert _msgpack.packb(manifest) == msgpack.packb(manifest) == raw


@settings(max_examples=300, deadline=None)
@given(_VALUES)
def test_codec_matches_msgpack_on_drawn_values(value):
    assert _msgpack.packb(value) == msgpack.packb(value)
    assert _msgpack.unpackb(msgpack.packb(value)) == msgpack.unpackb(msgpack.packb(value), strict_map_key=False)


@pytest.mark.parametrize("value", [2**64, -2**63 - 1, object(), np.int64(3)], ids=["big", "small", "object", "np"])
def test_codec_refuses_what_msgpack_refuses(value):
    with pytest.raises((OverflowError, TypeError)):
        msgpack.packb(value)
    with pytest.raises((OverflowError, TypeError)):
        _msgpack.packb(value)


# ---- bad directories: the port raises the type JAX raises -----------------------------


def _rewrite_manifest(directory, edit):
    path = os.path.join(directory, store.MANIFEST_NAME)
    manifest = msgpack.unpackb(open(path, "rb").read(), strict_map_key=False)
    edit(manifest)
    with open(path, "wb") as f:
        f.write(msgpack.packb(manifest))


def _resave_leaf(directory, name, convert):
    leaf = os.path.join(directory, name)
    np.save(leaf, convert(np.load(leaf)))


def _bump_version(directory):
    _rewrite_manifest(directory, lambda m: m.update(layout_version=LAYOUT_VERSION + 1))


BREAKS = {
    "layout_version": (_bump_version, "layout version"),
    "dtype": (lambda d: _resave_leaf(d, "doc_remap.npy", lambda a: a.astype(np.int64)), "manifest"),
    "shape": (lambda d: _resave_leaf(d, "doc_remap.npy", lambda a: a[:-1]), "manifest"),
    "uncommitted": (lambda d: os.remove(os.path.join(d, COMMIT_MARKER)), "missing marker"),
    "tampered": (lambda d: _resave_leaf(d, "doc_remap.npy", lambda a: a ^ 1), "content hash"),
}


@pytest.mark.parametrize("break_name", list(BREAKS))
def test_a_broken_directory_raises_what_jax_raises(tiny_index, tmp_path, break_name):
    directory = str(tmp_path / "index")
    jax_store.save_index(directory, tiny_index)
    breaker, message = BREAKS[break_name]
    breaker(directory)
    with pytest.raises(Exception, match=message) as jax_err:
        jax_store.load_index(directory, verify=True)
    with pytest.raises(Exception, match=message) as port_err:
        store.load_index(directory, verify=True, device="cpu")
    assert type(port_err.value).__name__ == type(jax_err.value).__name__
    assert isinstance(port_err.value, (store.IndexStoreError, FileNotFoundError))


def test_expected_fingerprint_mismatch_raises(saved):
    jax_dir = saved[0]
    with pytest.raises(store.IndexStoreError, match="fingerprint"):
        store.load_index(jax_dir, expect_fingerprint="0" * 32, device="cpu")


def test_a_sharded_directory_raises_and_names_what_is_missing(tiny_index, tmp_path):
    """``load_index`` refuses a sharded set as JAX's does, and so does a
    local-backend engine's ``swap_index``, naming the backends that serve one
    (before anything flips); ``Retriever.load`` serves it sharded."""
    directory = str(tmp_path / "sharded")
    jax_store.save_sharded_index(directory, tiny_index, 2)
    with pytest.raises(jax_store.IndexStoreError, match="not an index manifest") as jax_err:
        jax_store.load_index(directory)
    with pytest.raises(store.IndexStoreError, match="not an index manifest") as port_err:
        store.load_index(directory, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    assert Retriever.load(directory, device="cpu").backend_name == "sharded"
    retr = Retriever.from_index(from_arrays(tiny_index, "cpu"), StaticConfig(gamma=8, gamma0=2), device="cpu")
    engine = retr.serve(max_batch=4)
    try:
        with pytest.raises(ValueError, match="backend 'local' serves one LSPIndex; a sharded index set needs"):
            engine.swap_index(directory)
        assert engine.epoch == 0 and engine.retriever is retr._backend  # nothing flipped
        request = SearchRequest(np.array([1, 2, 3], np.int32), np.ones(3, np.float32))
        got = engine.search(request).result(timeout=60)
        np.testing.assert_array_equal(got.doc_ids, retr.search(request).doc_ids)  # it serves on
    finally:
        engine.shutdown()
    assert store.manifest_format(directory) == jax_store.SHARDED_MANIFEST_FORMAT


# ---- the sharded format ---------------------------------------------------------------


def _tree_files(directory):
    """Every file under ``directory`` by relative path, with its bytes."""
    out = {}
    for root, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(root, name)
            out[os.path.relpath(path, directory)] = open(path, "rb").read()
    return out


@pytest.fixture(scope="module", params=[2, 3], ids=["2-shards", "3-shards-ragged"])
def sharded(request, tiny_index, tmp_path_factory):
    """The tiny index saved as a sharded set by JAX and by the port: 32
    superblocks in 2 shards of 16, or 3 of 11 with a ragged last shard."""
    n = request.param
    root = tmp_path_factory.mktemp(f"sharded{n}")
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    jax_fp = jax_store.save_sharded_index(jax_dir, tiny_index, n, JaxIndexBuildConfig(**BUILD))
    port_fp = store.save_sharded_index(port_dir, from_arrays(tiny_index, "cpu"), n, IndexBuildConfig(**BUILD))
    return n, jax_dir, jax_fp, port_dir, port_fp


def test_port_saved_sharded_set_is_byte_equal_and_loads_into_jax(sharded, tiny_index):
    n, jax_dir, jax_fp, port_dir, port_fp = sharded
    assert port_fp == jax_fp
    assert _tree_files(port_dir) == _tree_files(jax_dir)  # both manifests, every shard's files
    assert jax_store.read_sharded_manifest(port_dir)["fingerprint"] == port_fp
    loaded = jax_store.load_index_auto(port_dir, mmap=False, verify=True)
    assert isinstance(loaded, jax_store.ShardedIndex) and len(loaded.shards) == n
    assert loaded.n_superblocks == tiny_index.n_superblocks


def test_jax_saved_sharded_set_loads_into_the_port(sharded):
    n, jax_dir, jax_fp, _, _ = sharded
    got = store.load_index_auto(jax_dir, verify=True, device="cpu")
    assert isinstance(got, store.ShardedIndex) and got.fingerprint == jax_fp and len(got.shards) == n
    want = [from_arrays(s, "cpu") for s in jax_store.load_sharded_index(jax_dir)]
    for g, w in zip(got.shards, want):
        _assert_leaves_equal(g, w)
    for g, w in zip(store.load_sharded_index(jax_dir, mmap=False, verify=True, device="cpu"), want):
        _assert_leaves_equal(g, w)
    assert got.n_superblocks == store.read_sharded_manifest(jax_dir)["n_superblocks"]


@pytest.fixture(scope="module", params=[
    dict(b=8, c=8, kmeans_iters=1),
    dict(b=4, c=16, kmeans_iters=1, bound_bits=8, quant_granularity="global", doc_bits=16),
], ids=["4bit-row", "8bit-global-16bit-docs"])
def jax_built(request, tiny_corpus):
    from repro.index.builder import build_index as jax_build_index

    _, corpus, _ = tiny_corpus
    return jax_build_index(corpus.doc_ptr, corpus.tids, corpus.ws, corpus.vocab, JaxIndexBuildConfig(**request.param))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 5])
def test_shard_index_is_byte_equal_to_jax(jax_built, n_shards):
    """Both cuts of the packed bounds: words sliced where a shard starts and
    ends on a granule (the block matrix), granules unpacked where it does
    not (the superblock matrices); the last shard ragged where NS % P != 0."""
    from repro.distributed.retrieval import shard_index as jax_shard_index
    from repro_torch.distributed.retrieval import shard_index

    jax_idx = jax_built
    got = shard_index(from_arrays(jax_idx, "cpu"), n_shards)
    want = jax_shard_index(jax_idx, n_shards)
    assert len(got) == len(want) == n_shards
    for g, w in zip(got, want):
        _assert_leaves_equal(g, from_arrays(w, "cpu"))


def test_a_tampered_shard_fails_verify(sharded, tmp_path):
    import shutil

    _, jax_dir, _, _, _ = sharded
    directory = str(tmp_path / "copy")
    shutil.copytree(jax_dir, directory)
    _resave_leaf(os.path.join(directory, "shard-00001"), "doc_remap.npy", lambda a: a ^ 1)
    store.load_index_auto(directory, device="cpu")  # mmap fast path: no re-hash
    with pytest.raises(store.IndexStoreError, match="content hash"):
        store.load_index_auto(directory, verify=True, device="cpu")


# ---- the mutable format ---------------------------------------------------------------


def _mutate(mi, vocab):
    """The same mutation log on a MutableIndex of either package."""
    rng = np.random.default_rng(4)
    docs = [(rng.choice(vocab, 6, replace=False), rng.random(6, dtype=np.float32)) for _ in range(5)]
    docs.append((np.zeros(0, np.int32), np.zeros(0, np.float32)))  # an empty doc
    ids, _ = mi.add_docs(docs)
    mi.delete_docs([3, 100, ids[1]])
    return mi


@pytest.fixture(scope="module")
def mutable_saved(tiny_corpus, tiny_index, tmp_path_factory):
    """The tiny index promoted and mutated alike in both packages, saved by each."""
    from repro.index.mutable import MutableIndex as JaxMutableIndex
    from repro_torch.index.mutable import MutableIndex

    _, corpus, _ = tiny_corpus
    csr = (corpus.doc_ptr, corpus.tids, corpus.ws, corpus.vocab)
    jax_mi = _mutate(JaxMutableIndex(tiny_index, *csr, JaxIndexBuildConfig(**BUILD)), corpus.vocab)
    port_mi = _mutate(MutableIndex(from_arrays(tiny_index, "cpu"), *csr, IndexBuildConfig(**BUILD)), corpus.vocab)
    root = tmp_path_factory.mktemp("mutable")
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    jax_fp = jax_store.save_mutable_index(jax_dir, jax_mi)
    port_fp = store.save_mutable_index(port_dir, port_mi)
    return jax_dir, jax_fp, jax_mi, port_dir, port_fp, port_mi


def test_port_saved_mutable_index_is_byte_equal_and_loads_into_jax(mutable_saved):
    jax_dir, jax_fp, jax_mi, port_dir, port_fp, _ = mutable_saved
    assert port_fp == jax_fp
    assert _files(port_dir) == _files(jax_dir)
    loaded = jax_store.load_mutable_index(port_dir, mmap=False, verify=True)
    assert loaded.pressure() == jax_mi.pressure()
    assert jax_store.read_mutable_manifest(port_dir)["meta"] == jax_store.read_mutable_manifest(jax_dir)["meta"]


def test_jax_saved_mutable_index_loads_into_the_port(mutable_saved):
    jax_dir, _, jax_mi, _, _, port_mi = mutable_saved
    got = store.load_mutable_index(jax_dir, verify=True, device="cpu")
    _assert_leaves_equal(got.state().main, from_arrays(jax_store.load_mutable_index(jax_dir).state().main, "cpu"))
    assert got.pressure() == jax_mi.pressure() == port_mi.pressure()
    want, have = jax_mi.persistable_state(), got.persistable_state()
    assert want["meta"] == have["meta"] and want["arrays"].keys() == have["arrays"].keys()
    for name, arr in want["arrays"].items():
        assert have["arrays"][name].dtype == arr.dtype and np.array_equal(have["arrays"][name], arr), name
    assert got.build_cfg == IndexBuildConfig(**BUILD)
    assert got.add_docs([(np.array([1], np.int32), np.ones(1, np.float32))])[0] == jax_mi.add_docs(
        [(np.array([1], np.int32), np.ones(1, np.float32))])[0]  # the next id, in both


@pytest.mark.parametrize("leaf", ["state.tombstones.npy", "state.delta_ws.npy", "main.doc_remap.npy"])
def test_a_tampered_mutable_leaf_fails_verify(mutable_saved, tmp_path, leaf):
    import shutil

    directory = str(tmp_path / "copy")
    shutil.copytree(mutable_saved[0], directory)
    _resave_leaf(directory, leaf, lambda a: a + 1)
    with pytest.raises(jax_store.IndexStoreError, match="content hash"):
        jax_store.load_mutable_index(directory, verify=True)
    with pytest.raises(store.IndexStoreError, match="content hash"):
        store.load_mutable_index(directory, verify=True, device="cpu")


def test_load_index_auto_tells_the_formats_apart(saved, mutable_saved, tiny_index, tmp_path):
    jax_dir = saved[0]
    assert isinstance(store.load_index_auto(jax_dir, device="cpu"), LSPIndex)
    sharded_dir = str(tmp_path / "sharded")
    store.save_sharded_index(sharded_dir, from_arrays(tiny_index, "cpu"), 2)
    assert isinstance(store.load_index_auto(sharded_dir, device="cpu"), store.ShardedIndex)
    with pytest.raises(jax_store.IndexStoreError, match="load_mutable_index") as jax_err:
        jax_store.load_index_auto(mutable_saved[3])
    with pytest.raises(store.IndexStoreError, match="load_mutable_index") as port_err:
        store.load_index_auto(mutable_saved[3], device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    for read in (store.read_mutable_manifest, store.read_sharded_manifest):
        with pytest.raises(store.IndexStoreError, match="not a"):
            read(jax_dir)
