"""The process-group front end: one serving engine on rank 0 over a shard set
held by every rank of a ``torch.distributed`` group.

The process-group transport (``distributed/sharded.py``, backend
``shard_map``) is SPMD: every rank calls its retriever with the same batch,
and the ranks' collectives meet. A serving engine runs on one process, so
rank 0 holds the engine and the other ranks follow it:

    rank 0:  front = GroupFrontEnd(group, device)
             retr = front.open(sharded_dir, static_cfg, params)  # every rank loads its own shard
             eng = retr.serve(...)                               # the bucketed engine, as ever
             eng.swap_index(other_sharded_dir)                   # every rank loads, warms, then flips
             ...; eng.shutdown(); front.close()
    others:  Follower(group, device).run()

Rank 0 sends each operation (open a shard set, search a batch, warm the
ladder's shapes, release a set, heartbeat, shutdown) to the followers before
it takes part in the operation's collectives. Every operation goes through
one ordered channel: a thread of rank 0 that takes them one at a time from a
queue, so the engine's worker and a swap's warm-up on the caller's thread
never issue collectives on the group at once (two threads doing so in
different orders on different ranks would deadlock or mix their data). The
operations travel on a gloo group (the group itself, or a gloo group over its
ranks when it is NCCL: ``control_group``).

A search names the shard set it runs on, so the followers serve whichever
set rank 0's engine snapshot for that batch: the sets flip on every rank
exactly when rank 0's engine flips its epoch. ``open`` is how a swap starts:
every rank loads only its own shard of the committed directory, and the
ranks gather each other's outcome; a load that fails on any rank raises on
rank 0's calling thread (``IndexStoreError``, naming the ranks) and the old
set keeps serving. A set is released on every rank when rank 0 drops its
last reference to it.

Every wait has a timeout. The followers wait for the next operation at most
the group's timeout, and rank 0 sends a heartbeat when it has had nothing
else to send for ``HEARTBEAT_S``, so an idle engine keeps them. Rank 0 waits
for each operation at most ``GROUP_TIMEOUT_S``. A rank that dies, raises or misses a
collective's timeout breaks the front end: the operation in flight and every
later one fail with ``ShardGroupError``, so the engine fails every pending
request with it, and none is dropped silently. A follower that raises
leaves its loop (and its process, in the launcher), which is how rank 0
learns of it. ``close`` sends the shutdown, and every rank meets at a
barrier before any destroys its group.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import weakref
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.config import DynamicParams, StaticConfig
from repro_torch.core.lsp import validate_dynamic
from repro_torch.core.query import QueryBatch
from repro_torch.device import on_device, resolve_device
from repro_torch.serve.errors import ShardGroupError

GROUP_TIMEOUT_S = 300.0  # the longest any wait of the front end or its followers lasts
HEARTBEAT_S = 1.0  # rank 0 sends a heartbeat after this long with nothing else to send


def control_group(group):
    """The gloo group the front end's operations travel on: ``group`` itself
    when it is gloo, else a gloo group over its ranks (NCCL moves device
    tensors only). Every rank of the world calls it, in the same order."""
    if dist.get_backend(group) == "gloo":
        return group
    return dist.new_group(dist.get_process_group_ranks(group), backend="gloo",
                          timeout=timedelta(seconds=GROUP_TIMEOUT_S))


def _send(control, op: tuple) -> None:
    dist.broadcast_object_list([op], src=dist.get_process_group_ranks(control)[0], group=control)


def _recv(control) -> tuple:
    box = [None]
    dist.broadcast_object_list(box, src=dist.get_process_group_ranks(control)[0], group=control)
    return box[0]


def _open_local(group, control, directory: str, scfg: StaticConfig, defaults: DynamicParams, impl: str,
                device: torch.device):
    """This rank's shard of the committed sharded ``directory``, then every
    rank's outcome: (the retriever or None, the failures by rank)."""
    from repro_torch.distributed.sharded import ShardedRetriever

    try:
        local, err = ShardedRetriever.from_dir(directory, scfg, group=group, impl=impl, defaults=defaults,
                                               device=device), None
    except Exception as exc:  # noqa: BLE001 - reported to every rank; rank 0 raises it
        local, err = None, f"{type(exc).__name__}: {exc}"
    errors = [None] * dist.get_world_size(control)
    dist.all_gather_object(errors, err, group=control)
    failed = {r: e for r, e in enumerate(errors) if e is not None}
    return (None if failed else local), failed


class Follower:
    """A rank other than 0: receives each operation of rank 0's front end
    and takes part in its collectives, until the shutdown. ``step()``
    handles one operation and returns its kind; ``run()`` handles them until
    the shutdown and returns how many it handled. Any exception leaves the
    loop: rank 0's next collective with this rank then fails."""

    def __init__(self, group, device=None):
        self.group = group
        self.control = control_group(group)
        self.device = resolve_device(device)
        self.sets: dict = {}

    def step(self) -> str:
        op = _recv(self.control)
        kind = op[0]
        if kind == "open":
            _, handle, directory, scfg, defaults, impl = op
            local, failed = _open_local(self.group, self.control, directory, scfg, defaults, impl, self.device)
            if not failed:
                self.sets[handle] = local
        elif kind == "search":
            _, handle, tids, ws, dyn = op
            local = self.sets[handle]
            local(QueryBatch(torch.from_numpy(tids).to(self.device), torch.from_numpy(ws).to(self.device),
                             local.vocab), dyn)
        elif kind == "warmup":
            _, handle, shapes = op
            self.sets[handle].warmup(shapes)
        elif kind == "release":
            self.sets.pop(op[1], None)
        elif kind == "shutdown":
            self.sets.clear()
            dist.monitored_barrier(self.control, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        elif kind != "heartbeat":
            raise ValueError(f"unknown front-end operation {kind!r}")
        return kind

    def run(self) -> int:
        n = 0
        with on_device(self.device):
            while True:
                n += 1
                if self.step() == "shutdown":
                    return n


class _GroupRetriever:
    """Rank 0's handle on one shard set the group serves: the dynamic-runner
    contract of ``core.lsp.make_dynamic_runner`` (what the engine calls),
    every call an operation of the front end's channel."""

    supports_dynamic = True

    def __init__(self, front: "GroupFrontEnd", handle: int, local):
        self._front = front
        self.handle = handle
        self.local = local  # rank 0's own ShardedRetriever over its shard
        self.static_cfg = local.static_cfg
        self.defaults = local.defaults
        self.vocab = local.vocab
        self.device = local.device

    def __call__(self, qb: QueryBatch, dyn=None):
        validate_dynamic(dyn, self.static_cfg)  # on rank 0, before any rank is sent the batch
        return self._front._call("search", self, qb, dyn)

    def warmup(self, shapes) -> None:
        self._front._call("warmup", self, [tuple(s) for s in shapes])

    def n_traces(self) -> int:
        return 0


class GroupFrontEnd:
    """Rank 0's side of the front end over ``group`` (rank 0 of ``group``
    constructs it; every other rank runs a ``Follower``). ``open`` serves a
    committed sharded directory as a ``Retriever`` whose engine
    (``retr.serve(...)``) drives every rank; ``close`` ends the followers."""

    def __init__(self, group, device=None):
        if dist.get_rank(group) != 0:
            raise ValueError("GroupFrontEnd runs on rank 0 of its group; the other ranks run a Follower")
        self.group = group
        self.control = control_group(group)
        self.device = resolve_device(device)
        self._ops: queue.Queue = queue.Queue()
        self._lock = threading.Lock()  # orders the broken check against each submission
        self._broken: Optional[ShardGroupError] = None
        self._closed = False
        self._handles = itertools.count()
        self._thread = threading.Thread(target=self._channel, name="group-front-end", daemon=True)
        self._thread.start()

    # ---- rank 0's callers --------------------------------------------------------

    def open(self, directory: str, static_cfg: StaticConfig, params: Optional[DynamicParams] = None,
             impl: str = "auto"):
        """Serve the committed sharded ``directory`` (``index.store.
        save_sharded_index``, as many shards as the group has ranks): every
        rank loads only its own shard. Returns a ``Retriever`` (backend
        'shard_map') whose ``serve()`` engine swaps with ``swap_index(dir)``
        of another such directory."""
        from repro_torch.api.retriever import Retriever
        from repro_torch.index.store import ShardedIndex, read_sharded_manifest

        defaults = (params or DynamicParams.recommended(static_cfg.k_max)).validate_for(static_cfg)
        first = self._open(directory, static_cfg, defaults, impl)

        def factory(path):
            if not isinstance(path, (str, os.PathLike)):
                raise ValueError("the process-group front end swaps to a committed sharded directory "
                                 "(index.store.save_sharded_index): each rank loads only its own shard")
            return self._open(os.fspath(path), static_cfg, defaults, impl)

        factory.takes_paths = True
        index = ShardedIndex(shards=tuple(first.local.shards), n_superblocks=first.local.ns_true,
                             fingerprint=read_sharded_manifest(directory)["fingerprint"])
        return Retriever(first, index=index, static_cfg=static_cfg, defaults=defaults, backend_name="shard_map",
                         factory=factory)

    def close(self) -> None:
        """Idempotent. Ends every follower's loop at a barrier (skipped when
        the group is broken) and stops the channel."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            broken = self._broken
            if broken is None:
                fut = Future()
                self._ops.put(("shutdown", (), fut))
        if broken is None:
            self._wait(fut, "shutdown")
        self._thread.join(timeout=GROUP_TIMEOUT_S)

    # ---- the channel -------------------------------------------------------------

    def _open(self, directory: str, scfg: StaticConfig, defaults: DynamicParams, impl: str) -> _GroupRetriever:
        handle = next(self._handles)
        local = self._call("open", handle, directory, scfg, defaults, impl)
        retr = _GroupRetriever(self, handle, local)
        weakref.finalize(retr, self._release, handle)
        return retr

    def _release(self, handle: int) -> None:
        with self._lock:
            if self._broken is None and not self._closed:
                self._ops.put(("release", (handle,), None))

    def _call(self, kind: str, *payload):
        with self._lock:
            if self._broken is not None:
                raise self._broken
            if self._closed:
                raise ShardGroupError("the group front end is closed")
            fut = Future()
            self._ops.put((kind, payload, fut))
        return self._wait(fut, kind)

    def _wait(self, fut: Future, kind: str):
        try:
            return fut.result(timeout=GROUP_TIMEOUT_S)
        except FutureTimeout:
            raise self._break(f"{kind}: no answer within {GROUP_TIMEOUT_S} s") from None

    def _break(self, why: str) -> ShardGroupError:
        """Mark the group broken and fail every queued operation."""
        with self._lock:
            if self._broken is None:
                self._broken = ShardGroupError(f"the process group serving the shard set failed ({why}); "
                                               "its requests are not served")
            err = self._broken
            while True:
                try:
                    _, _, fut = self._ops.get_nowait()
                except queue.Empty:
                    break
                if fut is not None:
                    fut.set_exception(err)
        return err

    def _channel(self) -> None:
        """The one thread that issues the group's operations, in queue order."""
        with on_device(self.device):
            while self._broken is None:
                try:
                    kind, payload, fut = self._ops.get(timeout=HEARTBEAT_S)
                except queue.Empty:
                    kind, payload, fut = "heartbeat", (), None
                try:
                    out = self._run_op(kind, *payload)
                except _OpenFailed as exc:  # every rank knows: the group stays in step
                    fut.set_exception(exc.error)
                    continue
                except Exception as exc:  # noqa: BLE001 - any other fault leaves the ranks out of step
                    err = self._break(f"{kind}: {type(exc).__name__}: {exc}")
                    if fut is not None:
                        fut.set_exception(err)
                    return
                if fut is not None:
                    fut.set_result(out)
                if kind == "shutdown":
                    return

    def _run_op(self, kind: str, *payload):
        if kind == "heartbeat":
            _send(self.control, ("heartbeat",))
        elif kind == "open":
            handle, directory, scfg, defaults, impl = payload
            _send(self.control, ("open", handle, directory, scfg, defaults, impl))
            local, failed = _open_local(self.group, self.control, directory, scfg, defaults, impl, self.device)
            if failed:
                from repro_torch.index.store import IndexStoreError

                raise _OpenFailed(IndexStoreError(
                    f"opening {directory} failed on rank(s) {sorted(failed)}: "
                    + "; ".join(f"rank {r}: {e}" for r, e in sorted(failed.items()))))
            return local
        elif kind == "search":
            retr, qb, dyn = payload
            _send(self.control, ("search", retr.handle, qb.tids.cpu().numpy(), qb.ws.cpu().numpy(), dyn))
            return retr.local(qb, dyn)
        elif kind == "warmup":
            retr, shapes = payload
            _send(self.control, ("warmup", retr.handle, shapes))
            retr.local.warmup(shapes)
        elif kind == "release":
            _send(self.control, ("release", *payload))
        elif kind == "shutdown":
            _send(self.control, ("shutdown",))
            dist.monitored_barrier(self.control, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        else:
            raise ValueError(f"unknown front-end operation {kind!r}")
        return None


class _OpenFailed(Exception):
    """A shard set some rank could not load: every rank knows, and the group
    stays in step."""

    def __init__(self, error: Exception):
        super().__init__(str(error))
        self.error = error

