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
from repro_torch.index.layout import LAYOUT_VERSION

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
    directory = str(tmp_path / "sharded")
    jax_store.save_sharded_index(directory, tiny_index, 2)
    with pytest.raises(jax_store.IndexStoreError):
        jax_store.load_index(directory)
    with pytest.raises(store.IndexStoreError, match="queue 1 item 2"):
        store.load_index(directory, device="cpu")
    with pytest.raises(store.IndexStoreError, match="queue 1 item 2"):
        Retriever.load(directory, device="cpu")
    assert store.manifest_format(directory) == jax_store.SHARDED_MANIFEST_FORMAT
