"""Atomic checkpoints of training state, and the atomic directory commit they
share with the index store.

Layout, the JAX package's:
         <dir>/step_<N>/arrays.npz.zz  (zlib-compressed npz of the flat tree's leaves)
         <dir>/step_<N>/meta.msgpack  (step, leaf paths, shapes, dtypes)
         <dir>/step_<N>/.complete  (commit marker -> atomicity)
Leaves are keyed by their tree paths (``params/layers/0/attn/wq``,
``opt_state/m/...``, ``step``), so a checkpoint either package writes restores in
the other. The port always writes zlib and reads zlib; the JAX package writes
zstd where its host has ``zstandard``, which the port cannot read (the card
machine has no ``zstandard``), and restoring such a checkpoint raises the JAX
package's own error. The meta goes through the port's MessagePack codec.
zlib at the JAX package's level 3 deflates float32 state at tens of MB/s on one
core, so the port deflates 16 MB chunks on all cores and joins them into one
zlib stream (pigz's layout), which any zlib reader inflates.

A directory of files becomes visible all-or-nothing: it is written under a
tmp name, each file fsync'ed, renamed into place, and only then given its
commit marker. An async save copies every leaf to the host before its writer
thread starts, so the steps that follow, which update the parameters in place,
cannot change what it writes.
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Optional

import numpy as np
import torch

from repro_torch.common.tree_utils import flatten_with_paths, tree_map
from repro_torch.index import _msgpack

COMMIT_MARKER = ".complete"

_dir_locks: dict[str, threading.Lock] = {}
_dir_locks_guard = threading.Lock()


def dir_lock(directory: str) -> threading.Lock:
    """One lock per (absolute) directory: serializes concurrent writers, which
    would otherwise race each other's tmp dirs and renames."""
    key = os.path.abspath(directory)
    with _dir_locks_guard:
        return _dir_locks.setdefault(key, threading.Lock())


@contextlib.contextmanager
def atomic_commit_dir(final: str) -> Iterator[str]:
    """Yield a tmp directory to populate; on clean exit it atomically replaces
    ``final`` and gains the commit marker. On error the tmp dir is removed and
    ``final`` is untouched. A previous committed copy is moved aside (not
    deleted) until the new marker is durable, so a crash in the replace window
    never leaves zero loadable copies."""
    tmp = final + ".tmp"
    old = final + ".old"
    for stale in (tmp, old):
        if os.path.exists(stale):
            shutil.rmtree(stale)
    os.makedirs(tmp)
    try:
        yield tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(final):
        os.rename(final, old)
    os.rename(tmp, final)
    with open(os.path.join(final, COMMIT_MARKER), "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    shutil.rmtree(old, ignore_errors=True)


def is_complete(path: str) -> bool:
    """True iff ``path`` is a committed (fully written) directory."""
    return os.path.exists(os.path.join(path, COMMIT_MARKER))


def fsync_write(path: str, data: bytes) -> None:
    """Write + flush + fsync: the commit rename must not outrun the data blocks."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


# Compressed-array file names of the two codecs; the port writes zlib only.
_ZSTD_NAME = "arrays.npz.zst"
_ZLIB_NAME = "arrays.npz.zz"
_ZLIB_LEVEL = 3  # the JAX package's
_CHUNK = 1 << 24


def _zlib_compress(data: bytes) -> bytes:
    """``data`` as one zlib stream, its chunks deflated in parallel threads
    (zlib releases the GIL). Every chunk but the last ends in a sync flush,
    which byte-aligns it and leaves its last block open, so the raw deflate
    outputs concatenate into one deflate stream; the header and the Adler-32
    of the whole data make it a zlib stream."""
    view = memoryview(data)
    chunks = [view[i: i + _CHUNK] for i in range(0, len(view), _CHUNK)] or [view]

    def deflate(i: int) -> bytes:
        c = zlib.compressobj(_ZLIB_LEVEL, zlib.DEFLATED, -15)
        return c.compress(chunks[i]) + c.flush(zlib.Z_FINISH if i == len(chunks) - 1 else zlib.Z_SYNC_FLUSH)

    with ThreadPoolExecutor(max_workers=min(len(chunks), os.cpu_count() or 1)) as pool:
        body = b"".join(pool.map(deflate, range(len(chunks))))
    return b"\x78\x5e" + body + struct.pack(">I", zlib.adler32(view))  # 0x785e: deflate, 32 KB window, level 2-5


def _decompress(path: str) -> bytes:
    zst = os.path.join(path, _ZSTD_NAME)
    if os.path.exists(zst):
        raise RuntimeError(f"{zst} needs the zstandard module, which is unavailable")
    with open(os.path.join(path, _ZLIB_NAME), "rb") as f:
        return zlib.decompress(f.read())


def _host_copy(x: torch.Tensor) -> np.ndarray:
    """A host array that nothing else holds: the caller may update ``x`` next."""
    return x.detach().to("cpu", copy=True).numpy()


def save_checkpoint(
    directory: str, step: int, tree: Any, keep: int = 3, async_write: bool = False
) -> Optional[threading.Thread]:
    """Serialize a tree -> <dir>/step_<step>. Returns the writer thread when async."""
    os.makedirs(directory, exist_ok=True)
    host = {k: _host_copy(v) for k, v in flatten_with_paths(tree).items()}  # device->host copy happens here
    meta = {
        "step": step,
        "keys": list(host.keys()),
        "shapes": {k: list(v.shape) for k, v in host.items()},
        "dtypes": {k: str(v.dtype) for k, v in host.items()},
    }

    def write():
        # per-directory lock: overlapping async saves (or a save racing another
        # save's _gc) must not rename/rmtree the same dirs concurrently
        with dir_lock(directory):
            with atomic_commit_dir(os.path.join(directory, f"step_{step}")) as tmp:
                buf = io.BytesIO()
                np.savez(buf, **host)
                fsync_write(os.path.join(tmp, _ZLIB_NAME), _zlib_compress(buf.getbuffer()))
                fsync_write(os.path.join(tmp, "meta.msgpack"), _msgpack.packb(meta))
            _gc(directory, keep)

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _gc(directory: str, keep: int) -> None:
    steps = sorted(_complete_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)


def _complete_steps(directory: str) -> list[int]:
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith((".tmp", ".old")):
            if is_complete(os.path.join(directory, name)):
                out.append(int(name.split("_")[1]))
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = _complete_steps(directory)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, target: Any, step: Optional[int] = None,
                       shardings: Any = None) -> tuple[Any, int]:
    """Restore into the structure of ``target`` (a tree of tensors): each leaf
    by its own path key, cast to the target leaf's dtype, on the target leaf's
    device. Returns (tree, step).

    With ``shardings`` (a matching tree of ``distributed.sharding.NamedSharding``
    placements over a ``DeviceMesh``), each leaf comes back as this rank's
    shard under its placement, on the mesh's device: the elastic-resharding
    path (restore onto a different mesh than the saver's). Only the target's
    shapes and dtypes are read then, so it may lie on the ``meta`` device."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step}")
    if not is_complete(path):
        # an explicit step must honour the commit marker too: step_<N> may exist as
        # an uncommitted or half-deleted directory and must never be loaded
        raise FileNotFoundError(f"checkpoint {path} has no {COMMIT_MARKER} marker")
    arrays = np.load(io.BytesIO(_decompress(path)))  # each member is read when it is asked for

    flat_target = flatten_with_paths(target)
    missing = set(flat_target) - set(arrays.files)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")

    flat_shard = flatten_with_paths(shardings) if shardings is not None else None
    new_leaves = []
    for k, leaf in flat_target.items():
        arr = arrays[k]
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch for {k}: ckpt {arr.shape} vs target {tuple(leaf.shape)}")
        if flat_shard is None:
            new_leaves.append(torch.from_numpy(arr).to(leaf.dtype).to(leaf.device))
        else:
            sh = flat_shard[k]
            piece = np.ascontiguousarray(sh.local_slice(arr))
            new_leaves.append(torch.from_numpy(piece).to(leaf.dtype).to(sh.mesh.device))
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), target), step
