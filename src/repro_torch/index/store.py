"""A persisted LSPIndex: the JAX package's ``lsp-index`` directory format.

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
else ``IndexStoreError``. The JAX package's sharded and mutable formats are
refused with ``IndexStoreError``; the port cannot read them yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any, Optional

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
# the JAX package's other two formats, and what the port still lacks to read them
_UNPORTED_FORMATS = {
    "lsp-sharded-index": "sharded index sets wait for the port of save_sharded_index / load_sharded_index "
                         "(ROADMAP.md, queue 1 item 2)",
    "lsp-mutable-index": "mutable indexes wait for the port of the mutable index (ROADMAP.md, queue 1 item 3)",
}

# Every NamedTuple node that may appear in an LSPIndex, by manifest type tag: a
# load can only ever construct these types.
_NODE_TYPES = {t.__name__: t for t in (LSPIndex, PackedBounds, FwdDocs, FlatInv, FwdDocsQ, FlatDocsQ)}


class IndexStoreError(RuntimeError):
    """Manifest/layout/fingerprint mismatch: the on-disk index cannot be trusted."""


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
    parent = os.path.dirname(os.path.abspath(directory))
    os.makedirs(parent, exist_ok=True)
    with dir_lock(parent):
        with atomic_commit_dir(os.path.abspath(directory)) as tmp:
            for key, arr in arrays.items():
                _save_leaf(os.path.join(tmp, key + ".npy"), arr)
            fsync_write(os.path.join(tmp, MANIFEST_NAME), _msgpack.packb(manifest))
    return fingerprint


def _read_raw_manifest(directory: str) -> dict:
    if not is_complete(directory):
        raise FileNotFoundError(f"{directory} is not a committed index (missing marker)")
    with open(os.path.join(directory, MANIFEST_NAME), "rb") as f:
        return _msgpack.unpackb(f.read())


def manifest_format(directory: str) -> str:
    """The ``format`` tag of a committed index directory."""
    return str(_read_raw_manifest(directory).get("format"))


def read_manifest(directory: str) -> dict:
    """The manifest of a committed single-index directory (version, fingerprint, config)."""
    manifest = _read_raw_manifest(directory)
    fmt = manifest.get("format")
    if fmt in _UNPORTED_FORMATS:
        raise IndexStoreError(f"{directory}: a {fmt!r} directory; {_UNPORTED_FORMATS[fmt]}")
    if fmt != MANIFEST_FORMAT:
        raise IndexStoreError(f"{directory}: not an index manifest ({fmt!r})")
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
    if manifest["layout_version"] != LAYOUT_VERSION:
        raise IndexStoreError(
            f"{directory}: layout version {manifest['layout_version']} != "
            f"code version {LAYOUT_VERSION}; rebuild the index"
        )
    if expect_fingerprint is not None and manifest["fingerprint"] != expect_fingerprint:
        raise IndexStoreError(f"{directory}: fingerprint {manifest['fingerprint']} != expected {expect_fingerprint}")
    tree = _decode(manifest["tree"], directory, mmap)
    if verify:
        arrays: dict[str, np.ndarray] = {}
        _encode(tree, "", arrays)
        actual = _fingerprint(arrays)
        if actual != manifest["fingerprint"]:
            raise IndexStoreError(
                f"{directory}: content hash {actual} != manifest fingerprint "
                f"{manifest['fingerprint']} (corrupted or tampered leaves)"
            )
    return from_arrays(tree, device)


def build_config_of(directory: str) -> Optional[IndexBuildConfig]:
    """The IndexBuildConfig recorded at save time, if any."""
    cfg = read_manifest(directory).get("build_config")
    return IndexBuildConfig(**cfg) if cfg is not None else None
