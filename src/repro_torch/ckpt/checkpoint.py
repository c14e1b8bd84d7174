"""Atomic directory commit, shared by the index store.

A directory of files becomes visible all-or-nothing: it is written under a
tmp name, each file fsync'ed, renamed into place, and only then given its
commit marker. A copy of the four helpers of the JAX package's
``ckpt/checkpoint.py`` (that module also saves training state and imports
JAX); the port's checkpoints of training state come with the model stack.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import threading
from typing import Iterator

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
