"""Persisted indexes: the JAX package's three directory formats.

An ``lsp-index`` directory holds one LSPIndex:

    <dir>/manifest.msgpack   format tag, layout version, IndexBuildConfig,
                             content fingerprint, and the typed tree (every
                             scalar field inline, every array field's dtype,
                             shape and file name)
    <dir>/<leaf>.npy         one raw numpy file per array leaf
    <dir>/.complete          commit marker (``ckpt.checkpoint``: tmp dir ->
                             fsync -> rename -> marker)

Directories are interchangeable with the JAX package's ``index/store.py``:
the manifest is written with the same bytes (``index._msgpack``), packed
bound words go to disk as ``uint32`` (the port holds them as int32 views),
and the fingerprint (blake2b over every leaf's path, dtype, shape and bytes,
in sorted path order) is computed over the same numpy leaves, so an index
saved by either package loads in the other with ``verify=True``.

Loading is structure-checked: the layout version must equal
``LAYOUT_VERSION`` and every leaf's dtype and shape must match the manifest,
else ``IndexStoreError``.

An ``lsp-sharded-index`` directory (``save_sharded_index``) holds one
``lsp-index`` directory per shard (``shard-00000``, ...) under a parent
manifest with the global superblock count and a global fingerprint (blake2b
over the shard fingerprints), committed as a whole. An ``lsp-mutable-index``
directory (``save_mutable_index``) holds a ``MutableIndex``: the main tree
(leaves under ``main.*``), the source corpus CSR, the delta segment, the
tombstones (leaves under ``state.*``) and the mutation counters, under one
fingerprint over every leaf. Both manifests are byte-equal to the JAX
package's, so either package reads what the other wrote.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import atomic_commit_dir, dir_lock, fsync_write, is_complete
from repro_torch.device import resolve_device
from repro_torch.index import _msgpack
from repro_torch.index.builder import IndexBuildConfig
from repro_torch.index.convert import from_arrays
from repro_torch.index.layout import (
    LAYOUT_VERSION,
    FlatDocsQ,
    FlatInv,
    FwdDocs,
    FwdDocsQ,
    LSPIndex,
    PackedBounds,
)

MANIFEST_NAME = "manifest.msgpack"
MANIFEST_FORMAT = "lsp-index"
SHARDED_MANIFEST_FORMAT = "lsp-sharded-index"
MUTABLE_MANIFEST_FORMAT = "lsp-mutable-index"

# Every NamedTuple node that may appear in an LSPIndex, by manifest type tag: a
# load can only ever construct these types.
_NODE_TYPES = {t.__name__: t for t in (LSPIndex, PackedBounds, FwdDocs, FlatInv, FwdDocsQ, FlatDocsQ)}


class IndexStoreError(RuntimeError):
    """Manifest/layout/fingerprint mismatch: the on-disk index cannot be trusted."""


class ShardedPromotionError(IndexStoreError, ValueError):
    """A sharded retriever cannot be promoted to mutable or saved in place.

    Shards are a serving projection of one logical index: the shard set
    carries padded superblock tails and no recoverable global corpus, so an
    in-place mutable promotion (or a ``Retriever.save`` of the shard list)
    would persist something that cannot round-trip. The error names the
    workaround for its operation (``operation`` and ``workaround`` are kept as
    attributes too). It is a ``ValueError`` as well, as in the JAX package."""

    def __init__(self, operation: str, workaround: str):
        self.operation = operation
        self.workaround = workaround
        super().__init__(f"{operation} is unsupported on a sharded index set — {workaround}")


def _host(t: torch.Tensor, field: str) -> np.ndarray:
    """A tensor leaf as the numpy array the JAX package saves: packed bound
    words as uint32 (the port holds their bits in int32)."""
    arr = t.detach().cpu().numpy()
    return arr.view(np.uint32) if field == "packed" else arr


def _encode(obj: Any, path: str, arrays: dict[str, np.ndarray]) -> dict:
    if obj is None:
        return {"kind": "none"}
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        arr = _host(obj, path.rsplit(".", 1)[-1]) if isinstance(obj, torch.Tensor) else obj
        arrays[path] = arr
        return {"kind": "array", "file": path + ".npy", "dtype": str(arr.dtype), "shape": list(arr.shape)}
    if isinstance(obj, np.generic):
        return {"kind": "scalar", "value": obj.item()}
    if isinstance(obj, (bool, int, float, str)):
        return {"kind": "scalar", "value": obj}
    node = _NODE_TYPES.get(type(obj).__name__)
    if node is not None and isinstance(obj, node):
        fields = {f: _encode(getattr(obj, f), f"{path}.{f}" if path else f, arrays) for f in obj._fields}
        return {"kind": type(obj).__name__, "fields": fields}
    raise TypeError(f"unsupported leaf at {path!r}: {type(obj)!r}")


def _decode(spec: dict, directory: str, mmap: bool) -> Any:
    """The tree of ``spec`` with numpy leaves (mmap-backed if ``mmap``)."""
    kind = spec["kind"]
    if kind == "none":
        return None
    if kind == "scalar":
        return spec["value"]
    if kind == "array":
        arr = np.load(os.path.join(directory, spec["file"]), mmap_mode="r" if mmap else None)
        if str(arr.dtype) != spec["dtype"] or list(arr.shape) != spec["shape"]:
            raise IndexStoreError(
                f"{spec['file']}: on-disk {arr.dtype}{list(arr.shape)} != manifest {spec['dtype']}{spec['shape']}"
            )
        return arr
    node = _NODE_TYPES.get(kind)
    if node is None:
        raise IndexStoreError(f"unknown node type {kind!r} in manifest")
    return node(**{f: _decode(s, directory, mmap) for f, s in spec["fields"].items()})


def _fingerprint(arrays: dict[str, np.ndarray]) -> str:
    """blake2b over every leaf's identity + bytes, in sorted leaf-path order."""
    h = hashlib.blake2b(digest_size=16)
    for key in sorted(arrays):
        arr = np.ascontiguousarray(arrays[key])
        h.update(f"{key}:{arr.dtype}:{arr.shape};".encode())
        h.update(arr)
    return h.hexdigest()


def _save_leaf(path: str, arr: np.ndarray) -> None:
    """``np.save`` straight to the file, fsync'ed before the commit marker."""
    with open(path, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())


def _commit(directory: str, arrays: dict[str, np.ndarray], manifest: dict) -> None:
    """Write every leaf and then the manifest under ``directory``, atomically."""
    parent = os.path.dirname(os.path.abspath(directory))
    os.makedirs(parent, exist_ok=True)
    with dir_lock(parent):
        with atomic_commit_dir(os.path.abspath(directory)) as tmp:
            for key, arr in arrays.items():
                _save_leaf(os.path.join(tmp, key + ".npy"), arr)
            fsync_write(os.path.join(tmp, MANIFEST_NAME), _msgpack.packb(manifest))


def _check_version(directory: str, manifest: dict) -> None:
    if manifest["layout_version"] != LAYOUT_VERSION:
        raise IndexStoreError(
            f"{directory}: layout version {manifest['layout_version']} != "
            f"code version {LAYOUT_VERSION}; rebuild the index"
        )


def _check_content(directory: str, arrays: dict[str, np.ndarray], manifest: dict) -> None:
    actual = _fingerprint(arrays)
    if actual != manifest["fingerprint"]:
        raise IndexStoreError(
            f"{directory}: content hash {actual} != manifest fingerprint "
            f"{manifest['fingerprint']} (corrupted or tampered leaves)"
        )


def save_index(directory: str, index: LSPIndex, cfg: Optional[IndexBuildConfig] = None) -> str:
    """Persist ``index`` (any device) under ``directory``, atomically replacing
    any previous committed copy. Returns the content fingerprint."""
    arrays: dict[str, np.ndarray] = {}
    tree = _encode(index, "", arrays)
    fingerprint = _fingerprint(arrays)
    manifest = {
        "format": MANIFEST_FORMAT,
        "layout_version": LAYOUT_VERSION,
        "fingerprint": fingerprint,
        "build_config": dataclasses.asdict(cfg) if cfg is not None else None,
        "tree": tree,
    }
    _commit(directory, arrays, manifest)
    return fingerprint


def _read_raw_manifest(directory: str) -> dict:
    if not is_complete(directory):
        raise FileNotFoundError(f"{directory} is not a committed index (missing marker)")
    with open(os.path.join(directory, MANIFEST_NAME), "rb") as f:
        return _msgpack.unpackb(f.read())


def manifest_format(directory: str) -> str:
    """The ``format`` tag of a committed index directory ("lsp-index",
    "lsp-sharded-index" or "lsp-mutable-index")."""
    return str(_read_raw_manifest(directory).get("format"))


def read_manifest(directory: str) -> dict:
    """The manifest of a committed single-index directory (version, fingerprint, config)."""
    manifest = _read_raw_manifest(directory)
    if manifest.get("format") != MANIFEST_FORMAT:
        raise IndexStoreError(f"{directory}: not an index manifest ({manifest.get('format')!r})")
    return manifest


def load_index(
    directory: str,
    mmap: bool = True,
    verify: bool = False,
    expect_fingerprint: Optional[str] = None,
    device=None,
) -> LSPIndex:
    """Load a persisted index onto ``device`` (CUDA by default). ``mmap`` opens
    the leaves disk-backed before they are copied to the device; ``verify``
    (or ``expect_fingerprint``) checks the content hash, which reads every
    page."""
    device = resolve_device(device)
    manifest = read_manifest(directory)
    _check_version(directory, manifest)
    if expect_fingerprint is not None and manifest["fingerprint"] != expect_fingerprint:
        raise IndexStoreError(f"{directory}: fingerprint {manifest['fingerprint']} != expected {expect_fingerprint}")
    tree = _decode(manifest["tree"], directory, mmap)
    if verify:
        arrays: dict[str, np.ndarray] = {}
        _encode(tree, "", arrays)
        _check_content(directory, arrays, manifest)
    return from_arrays(tree, device)


def build_config_of(directory: str) -> Optional[IndexBuildConfig]:
    """The IndexBuildConfig recorded at save time, if any."""
    cfg = read_manifest(directory).get("build_config")
    return IndexBuildConfig(**cfg) if cfg is not None else None


# ------------------------------------------------------------- sharded indexes


class ShardedIndex(NamedTuple):
    """A loaded sharded index: the shards' LSPIndexes + the global metadata a
    retriever needs (shard padding makes ``n_superblocks``, the true global
    superblock count, unrecoverable from the shards alone)."""

    shards: tuple  # tuple[LSPIndex, ...]
    n_superblocks: int
    fingerprint: str  # global content fingerprint (over the shard fingerprints)


def save_sharded_index(directory: str, index: LSPIndex, n_shards: int,
                       cfg: Optional[IndexBuildConfig] = None) -> str:
    """Cut ``index`` into ``n_shards`` contiguous superblock ranges
    (``distributed.retrieval.shard_index``, on the index's device, one shard
    at a time) and persist them under one atomically committed directory:

      <dir>/manifest.msgpack   format/version, n_shards, global superblock count,
                               the shard dirs and fingerprints, and the global
                               fingerprint (blake2b over the shard fingerprints)
      <dir>/shard-00000/       one lsp-index directory per shard (save_index)
      <dir>/.complete          whole-set commit marker

    The parent's marker lands only after every shard directory has committed,
    so a reader never sees a half-written set. Returns the global fingerprint."""
    from repro_torch.distributed.retrieval import _local_index

    parent = os.path.dirname(os.path.abspath(directory))
    os.makedirs(parent, exist_ok=True)
    with dir_lock(parent):
        with atomic_commit_dir(os.path.abspath(directory)) as tmp:
            shard_dirs, shard_fps = [], []
            for i in range(n_shards):
                name = f"shard-{i:05d}"
                shard_dirs.append(name)
                shard_fps.append(save_index(os.path.join(tmp, name), _local_index(index, i, n_shards), cfg))
            h = hashlib.blake2b(digest_size=16)
            for fp in shard_fps:
                h.update(fp.encode())
            manifest = {
                "format": SHARDED_MANIFEST_FORMAT,
                "layout_version": LAYOUT_VERSION,
                "n_shards": n_shards,
                "n_superblocks": index.n_superblocks,
                "n_docs": index.n_docs,
                "vocab": index.vocab,
                "shard_dirs": shard_dirs,
                "shard_fingerprints": shard_fps,
                "fingerprint": h.hexdigest(),
                "build_config": dataclasses.asdict(cfg) if cfg is not None else None,
            }
            fsync_write(os.path.join(tmp, MANIFEST_NAME), _msgpack.packb(manifest))
    return manifest["fingerprint"]


def read_sharded_manifest(directory: str) -> dict:
    manifest = _read_raw_manifest(directory)
    if manifest.get("format") != SHARDED_MANIFEST_FORMAT:
        raise IndexStoreError(f"{directory}: not a sharded index manifest ({manifest.get('format')!r})")
    return manifest


def load_sharded_index(directory: str, mmap: bool = True, verify: bool = False, device=None) -> list[LSPIndex]:
    """Load every shard of a persisted sharded index onto ``device`` (CUDA by
    default), each structure-checked and held to its fingerprint in the
    parent manifest. ``load_index_auto`` also returns the global metadata."""
    manifest = read_sharded_manifest(directory)
    _check_version(directory, manifest)
    return [
        load_index(os.path.join(directory, name), mmap=mmap, verify=verify, expect_fingerprint=fp, device=device)
        for name, fp in zip(manifest["shard_dirs"], manifest["shard_fingerprints"])
    ]


def load_shard_of(directory: str, rank: int, mmap: bool = True, verify: bool = False, device=None):
    """The ``ShardedIndex`` of a persisted set as one process-group rank holds
    it: shard ``rank`` loaded onto ``device`` (held to its fingerprint in the
    parent manifest), every other entry None. A rank past the set's shards
    gets no shard."""
    manifest = read_sharded_manifest(directory)
    _check_version(directory, manifest)
    shards = [None] * manifest["n_shards"]
    if rank < len(shards):
        shards[rank] = load_index(os.path.join(directory, manifest["shard_dirs"][rank]), mmap=mmap, verify=verify,
                                  expect_fingerprint=manifest["shard_fingerprints"][rank], device=device)
    return ShardedIndex(shards=tuple(shards), n_superblocks=manifest["n_superblocks"],
                        fingerprint=manifest["fingerprint"])


# ------------------------------------------------------------- mutable indexes


def save_mutable_index(directory: str, mutable, cfg: Optional[IndexBuildConfig] = None) -> str:
    """Persist a ``MutableIndex`` generation (the main tree, the source corpus
    CSR, the delta segment, the tombstones and the mutation counters) under
    one atomically committed directory. The fingerprint covers every leaf, so
    two saves of one logical corpus at different mutation points differ.
    Needs a main generation (``MutableIndex.persistable_state`` raises
    without one). Returns the content fingerprint."""
    state = mutable.persistable_state()
    arrays: dict[str, np.ndarray] = {}
    tree = _encode(state["main"], "main", arrays)
    state_specs = {
        name: _encode(np.ascontiguousarray(arr), f"state.{name}", arrays) for name, arr in state["arrays"].items()
    }
    fingerprint = _fingerprint(arrays)
    bcfg = cfg if cfg is not None else getattr(mutable, "build_cfg", None)
    manifest = {
        "format": MUTABLE_MANIFEST_FORMAT,
        "layout_version": LAYOUT_VERSION,
        "fingerprint": fingerprint,
        "build_config": dataclasses.asdict(bcfg) if bcfg is not None else None,
        "meta": {k: int(v) for k, v in state["meta"].items()},
        "tree": tree,
        "state": state_specs,
    }
    _commit(directory, arrays, manifest)
    return fingerprint


def read_mutable_manifest(directory: str) -> dict:
    manifest = _read_raw_manifest(directory)
    if manifest.get("format") != MUTABLE_MANIFEST_FORMAT:
        raise IndexStoreError(f"{directory}: not a mutable index manifest ({manifest.get('format')!r})")
    return manifest


def load_mutable_index(directory: str, mmap: bool = True, verify: bool = False, runtime=None, device=None):
    """Reconstruct a persisted ``MutableIndex``: the main tree on ``device``
    (CUDA by default; also where its compactions build), the corpus CSR, the
    delta segment replayed, the tombstones and the counters. ``mmap`` applies
    to the main tree only: the state arrays are read whole (the delta's
    buffers are mutable). ``runtime`` optionally attaches a backend."""
    from repro_torch.index.mutable import MutableIndex

    device = resolve_device(device)
    manifest = read_mutable_manifest(directory)
    _check_version(directory, manifest)
    main = _decode(manifest["tree"], directory, mmap)
    state_arrays = {name: np.array(_decode(spec, directory, False)) for name, spec in manifest["state"].items()}
    if verify:
        arrays: dict[str, np.ndarray] = {}
        _encode(main, "main", arrays)
        for name, arr in state_arrays.items():
            _encode(np.ascontiguousarray(arr), f"state.{name}", arrays)
        _check_content(directory, arrays, manifest)
    bcfg = manifest.get("build_config")
    return MutableIndex.restore(
        from_arrays(main, device),
        state_arrays,
        manifest["meta"],
        IndexBuildConfig(**bcfg) if bcfg is not None else None,
        runtime=runtime,
        device=device,
    )


def load_index_auto(directory: str, mmap: bool = True, verify: bool = False, device=None):
    """Load a committed directory of either immutable format onto ``device``:
    an ``LSPIndex`` for the single format, a ``ShardedIndex`` for the sharded
    one (what ``RetrievalEngine.swap_index`` reads). Mutable directories are
    refused: their delta and tombstones need the ``MutableIndex`` wrapper
    (``load_mutable_index``, or ``Retriever.load``, which re-promotes them)."""
    fmt = _read_raw_manifest(directory).get("format")
    if fmt == MUTABLE_MANIFEST_FORMAT:
        raise IndexStoreError(
            f"{directory}: mutable-index dir; use load_mutable_index() or "
            f"Retriever.load() — swap_index cannot serve delta/tombstone state"
        )
    if fmt == SHARDED_MANIFEST_FORMAT:
        manifest = read_sharded_manifest(directory)
        shards = load_sharded_index(directory, mmap=mmap, verify=verify, device=device)
        return ShardedIndex(shards=tuple(shards), n_superblocks=manifest["n_superblocks"],
                            fingerprint=manifest["fingerprint"])
    return load_index(directory, mmap=mmap, verify=verify, device=device)
