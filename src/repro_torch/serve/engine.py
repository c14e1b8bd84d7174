"""Bucketed batched retrieval serving engine.

Request flow: search(SearchRequest) -> admission (tenant token-bucket quota,
deadline stamping, priority lane) -> canonicalize + result-cache probe ->
bounded two-lane batching queue (blocking put = backpressure; a deadline that
expires while blocked or queued fails fast with ``DeadlineExceeded``, never
scored) -> smallest shape bucket covering the collected batch (batch × nq
ladder) -> retriever -> futures of SearchResponse + cache fill. A lone query
runs a batch-1 traversal instead of paying for max_batch padded rows; bucket
padding leaves results unchanged (sentinel terms and empty rows score
nothing).

Dynamic parameters: a retriever advertising ``supports_dynamic`` (the
runners of ``core.lsp.make_dynamic_runner``) serves mixed per-request
``DynamicParams`` overrides in one batch, as per-row tensors. Cache keys
include the dynamic-params bytes: distinct points never share an entry.
``SearchResponse`` carries provenance (epoch, cache_hit, the bucket that ran,
θ and visit counters, degraded/params_served).

SLO control: with ``slo=SLOConfig(...)`` a feedback controller watches queue
depth and the windowed p99 of served requests and, under pressure, walks the
effective per-request params down a validated degradation ladder (tighter
η/μ → capped query terms riding a smaller nq bucket → smaller k), recovering
with hysteresis. Degradation is resolved at admission, so the cache key always
matches the point served. Priority lanes: ``interactive`` requests preempt
``batch`` at every collect step. ``admission=AdmissionConfig(...)`` adds
per-tenant token buckets (``AdmissionRejected`` raised synchronously) and a
default deadline.

Failure semantics: a retriever exception (or an injected ``chaos`` fault)
fails exactly the futures of the batch that hit it and the loop keeps serving;
search() after shutdown() raises ``EngineShutdown``; shutdown() drains both
lanes and fails still-queued requests with ``EngineShutdown`` carrying each
request's id, so clients can tell shed load from crashes.

Devices: each batch is built on the serving retriever's ``device`` (CUDA when
the retriever names none), and the worker thread, like the thread that warms
a swap, enters that device before it launches anything: CUDA's current device
is per thread. Results cross to the host once per batch.

Index lifecycle: swap_index()/swap_retriever() hot-swap the retriever with
zero downtime: the replacement is built and warmed on the calling thread
while the worker keeps serving on the old one, then (retriever, epoch) flip
atomically between batches. Cache keys are ``(epoch, delta_seq,
query-bytes)``: the epoch retires every entry of a swapped-out index, and the
delta sequence (bumped by every mutation of a mutable retriever; 0 otherwise)
retires entries the moment an add or delete lands. Fills are keyed on the seq
the batch was served at (stamped on the result by the mutable adapter), so a
result computed against a retired corpus state never resurfaces.

Live mutation: when the retriever is a ``serve.mutable.MutableRetrieverAdapter``,
``add_docs``/``delete_docs`` ingest through the engine: the mutation bumps the
adapter's delta seq, purges stale cache entries, pokes the background
``CompactionManager`` (if attached), and lands in the ``adds``/``deletes``
counters and the ``delta_docs``/``tombstones``/``delta_seq`` gauges.

End-to-end latency percentiles cover served requests only: rejections, sheds
and deadline expiries have their own counters and never enter the latency
window. Queue-depth and SLO-level gauges ride ``ServeStats.summary()``.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
import warnings
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.api.types import SearchRequest, SearchResponse
from repro_torch.core.config import DynamicParams
from repro_torch.core.query import QueryBatch, canonical_query, make_query_batch, query_key
from repro_torch.device import on_device, resolve_device, to_host
from repro_torch.serve.admission import LANE_INTERACTIVE, AdmissionConfig, AdmissionController
from repro_torch.serve.buckets import Bucket, BucketLadder
from repro_torch.serve.cache import QueryResultCache
from repro_torch.serve.chaos import ChaosInjector
from repro_torch.serve.errors import AdmissionRejected, DeadlineExceeded, EngineShutdown
from repro_torch.serve.slo import SLOConfig, SLOController

_EMPTY_QUERY = (np.zeros(0, np.int32), np.zeros(0, np.float32))

# The failure boundary between "operational fault" (isolate the batch, keep
# serving) and "programming error" (fail the futures, then escalate).
# RuntimeError covers every typed serving error (ServeError and ChaosFault
# subclass it), torch's CUDA errors and the kernel wrappers' launch errors;
# TimeoutError/OSError cover transport and host-level faults. TypeError,
# AttributeError, ... stay outside on purpose: a bug in the worker must
# surface, not be swallowed as a "failure" counter.
_OPERATIONAL_ERRORS = (RuntimeError, TimeoutError, OSError)


def _retriever_device(retriever) -> torch.device:
    """Where ``retriever`` runs: its ``device`` attribute, CUDA if it has none."""
    return resolve_device(getattr(retriever, "device", None))


@dataclass
class ServeStats:
    """Serving metrics. Latencies live in a bounded ring buffer (percentiles are
    over the most recent window). Counters are mutated on the engine thread AND
    caller threads (cache hits resolve in search()); everything shares one lock.

    Counter taxonomy (each request lands in exactly one):
      requests          served (a result was produced; only these enter the
                        latency window)
      failures          futures failed by a retriever/chaos exception
      deadline_expired  failed fast with DeadlineExceeded, never scored
      quota_rejected    refused at admission (AdmissionRejected), never queued
      rejected          shed at shutdown (EngineShutdown) or post-stop submit
      degraded          subset of ``requests`` served below the requested point

    Gauges (live callables registered by the engine, evaluated at summary()
    time): ``queue_depth``, ``slo_level``, ``delta_docs``, ``tombstones``,
    ``delta_seq``."""

    window: int = 16384
    latencies_ms: deque = field(default=None)
    batches: int = 0
    requests: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    failures: int = 0
    rejected: int = 0
    deadline_expired: int = 0
    quota_rejected: int = 0
    degraded: int = 0
    swaps: int = 0
    last_swap_ms: float = 0.0
    bucket_batches: dict = field(default_factory=dict)  # (batch, nq) -> count
    adds: int = 0  # docs ingested via add_docs
    deletes: int = 0  # docs tombstoned via delete_docs
    compactions: int = 0  # background generation folds completed
    compaction_failures: int = 0  # operational compaction faults (the loop kept going)
    last_compaction_ms: float = 0.0
    # rows whose tombstone overfetch clipped at k_max (reported by
    # MutableRetrieverAdapter): each may come up short of k until compaction
    overfetch_saturated: int = 0

    def __post_init__(self):
        if self.latencies_ms is None:
            self.latencies_ms = deque(maxlen=self.window)
        self._lock = threading.Lock()
        self._gauges: dict = {}

    def register_gauge(self, name: str, fn: Callable[[], float]) -> None:
        """Expose a live reading (queue depth, SLO level, ...) in summary()."""
        self._gauges[name] = fn

    def record(self, latency_ms: float, cache_hit: bool = False, degraded: bool = False) -> None:
        with self._lock:
            self.latencies_ms.append(latency_ms)
            self.requests += 1
            if cache_hit:
                self.cache_hits += 1
            if degraded:
                self.degraded += 1

    def record_cache_miss(self) -> None:
        with self._lock:
            self.cache_misses += 1

    def record_batch(self, bucket: Bucket) -> None:
        with self._lock:
            self.batches += 1
            key = (bucket.batch, bucket.nq)
            self.bucket_batches[key] = self.bucket_batches.get(key, 0) + 1

    def record_failures(self, n: int) -> None:
        with self._lock:
            self.failures += n

    def record_rejected(self, n: int = 1) -> None:
        with self._lock:
            self.rejected += n

    def record_deadline_expired(self, n: int = 1) -> None:
        # does NOT touch the latency window: a fast-failed request has a tiny
        # "latency" that would drag p50/p99 down under overload
        with self._lock:
            self.deadline_expired += n

    def record_quota_rejected(self, n: int = 1) -> None:
        with self._lock:
            self.quota_rejected += n

    def record_swap(self, latency_ms: float) -> None:
        with self._lock:
            self.swaps += 1
            self.last_swap_ms = latency_ms

    def record_adds(self, n: int) -> None:
        with self._lock:
            self.adds += n

    def record_deletes(self, n: int) -> None:
        with self._lock:
            self.deletes += n

    def record_compaction(self, latency_ms: float) -> None:
        with self._lock:
            self.compactions += 1
            self.last_compaction_ms = latency_ms

    def record_compaction_failed(self) -> None:
        with self._lock:
            self.compaction_failures += 1

    def record_overfetch_saturated(self, n: int) -> None:
        with self._lock:
            self.overfetch_saturated += n

    def _snapshot(self) -> np.ndarray:
        with self._lock:
            return np.asarray(self.latencies_ms, dtype=np.float64)

    def percentile(self, p: float) -> float:
        lat = self._snapshot()
        return float(np.percentile(lat, p)) if lat.size else 0.0

    def summary(self) -> dict:
        with self._lock:
            lat = np.asarray(self.latencies_ms, dtype=np.float64)
            probes = self.cache_hits + self.cache_misses
            out = {
                "requests": self.requests,
                "batches": self.batches,
                "failures": self.failures,
                "rejected": self.rejected,
                "deadline_expired": self.deadline_expired,
                "quota_rejected": self.quota_rejected,
                "degraded": self.degraded,
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "cache_hit_rate": self.cache_hits / probes if probes else 0.0,
                "swaps": self.swaps,
                "last_swap_ms": self.last_swap_ms,
                "adds": self.adds,
                "deletes": self.deletes,
                "compactions": self.compactions,
                "compaction_failures": self.compaction_failures,
                "last_compaction_ms": self.last_compaction_ms,
                "overfetch_saturated": self.overfetch_saturated,
                "bucket_batches": {f"{b}x{q}": n for (b, q), n in sorted(self.bucket_batches.items())},
                "mean_ms": float(lat.mean()) if lat.size else 0.0,
                "p50_ms": float(np.percentile(lat, 50)) if lat.size else 0.0,
                "p99_ms": float(np.percentile(lat, 99)) if lat.size else 0.0,
            }
        for name, fn in self._gauges.items():  # outside the lock: gauges own their sync
            try:
                out[name] = fn()
            except _OPERATIONAL_ERRORS:  # a dead gauge must not break summary();
                out[name] = None  # a buggy one (TypeError, ...) must still surface
        return out


@dataclass(frozen=True)
class _Record:
    """What the worker computed for one request: the unit the cache stores and
    a ``SearchResponse`` is minted from (fresh copies per response, so cached
    rows never alias what callers may mutate)."""

    ids: np.ndarray
    scores: np.ndarray
    theta: Optional[float]
    nsb: Optional[int]
    nblk: Optional[int]
    params: Optional[DynamicParams]
    bucket: tuple
    shard_candidates: Optional[np.ndarray]
    degraded: bool = False


@dataclass
class _Item:
    """One admitted request riding the queue."""

    t0: float  # admission timestamp (monotonic)
    tids: np.ndarray  # canonical, possibly nq-capped by the SLO controller
    ws: np.ndarray
    eff: Optional[DynamicParams]  # effective override to serve (None = defaults)
    degraded: bool  # served below the requested/default point?
    key: Optional[bytes]  # cache key sans epoch (None = cache off)
    fut: Future
    request_id: str
    expiry: Optional[float]  # absolute monotonic deadline (None = none)
    lane: int


def _response_from(rec: _Record, epoch: int, cache_hit: bool, delta_seq: int = 0) -> SearchResponse:
    return SearchResponse(
        doc_ids=rec.ids.copy(),
        scores=rec.scores.copy(),
        theta=rec.theta,
        n_superblocks_visited=rec.nsb,
        n_blocks_scored=rec.nblk,
        params=rec.params,
        epoch=epoch,
        cache_hit=cache_hit,
        bucket=rec.bucket,
        shard_candidates=None if rec.shard_candidates is None else rec.shard_candidates.copy(),
        degraded=rec.degraded,
        params_served=rec.params,
        delta_seq=delta_seq,
    )


def _try_set_result(fut: Future, value) -> None:
    try:
        fut.set_result(value)
    except InvalidStateError:
        pass  # caller cancelled the future; the result is simply dropped


def _try_set_exception(fut: Future, exc: BaseException) -> None:
    try:
        fut.set_exception(exc)
    except InvalidStateError:
        pass


class RetrievalEngine:
    """retriever: QueryBatch -> RetrievalResult, or any (ids [Q, k], scores [Q, k])
    prefix tuple of tensors or arrays; the runners of
    ``core.lsp.make_dynamic_runner`` (what ``api.Retriever`` serves) plug in
    directly. The retriever's ``device`` attribute (CUDA if absent) is where
    each batch is built and run.

    A retriever with ``supports_dynamic`` accepts ``(qb, [DynamicParams, ...])``
    and unlocks per-request overrides through ``search()``; ``default_params``
    (falling back to the retriever's own ``defaults``) is the point served when
    a request carries none.

    ``batch_buckets=[max_batch]`` + ``cache_size=0`` pads every batch to one
    shape with no memoization. ``queue_depth`` bounds each lane of the
    batching queue; a full lane blocks search() (backpressure) instead of
    growing without bound, and a deadline that expires while blocked fails
    fast.

    ``retriever_factory`` (LSPIndex -> retriever) enables ``swap_index``: the
    engine can then rebuild its retriever from a freshly loaded index without
    a restart. A bare-retriever engine still supports ``swap_retriever``.

    SLO layer (all optional): ``slo=SLOConfig(...)`` runs the degradation
    controller, ``admission=AdmissionConfig(...)`` adds tenant quotas and
    default deadlines, ``chaos=ChaosInjector(...)`` injects faults / latency
    spikes inside the worker's failure-isolation boundary.
    """

    def __init__(
        self,
        retriever: Callable[[QueryBatch], tuple],
        vocab: int,
        max_batch: int = 32,
        nq_max: int = 64,
        max_wait_ms: float = 2.0,
        stats_window: int = 16384,
        batch_buckets: list[int] | None = None,
        nq_buckets: list[int] | None = None,
        cache_size: int = 1024,
        queue_depth: int = 0,
        warmup: bool = False,
        retriever_factory: Callable | None = None,
        default_params: Optional[DynamicParams] = None,
        admission: Optional[AdmissionConfig] = None,
        slo: Optional[SLOConfig] = None,
        chaos: Optional[ChaosInjector] = None,
    ):
        self.retriever = retriever
        self.retriever_factory = retriever_factory
        self.default_params = default_params
        self.vocab = vocab
        self._epoch = 0  # bumps on every swap; participates in the cache key
        self._retriever_lock = threading.Lock()  # guards the (retriever, epoch) flip
        self._swap_lock = threading.Lock()  # serializes whole swaps (build + warm + flip)
        self.ladder = BucketLadder(max_batch, nq_max, batch_buckets, nq_buckets)
        self.max_batch = self.ladder.max_batch
        self.nq_max = self.ladder.nq_max
        self.max_wait_ms = max_wait_ms
        self.stats = ServeStats(window=stats_window)
        self.cache = QueryResultCache(cache_size) if cache_size else None
        depth = queue_depth or 4 * self.max_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)  # interactive lane
        self._q_batch: queue.Queue = queue.Queue(maxsize=depth)  # batch lane
        self._seq = itertools.count()
        self.admission = AdmissionController(admission) if admission is not None else None
        self.chaos = chaos
        self.slo = None
        if slo is not None:
            self.slo = SLOController(
                slo,
                queue_capacity=depth,
                defaults=self._default_params() or DynamicParams(),
                nq_max=self.nq_max,
                static=getattr(retriever, "static_cfg", None),
            )
        self.stats.register_gauge("queue_depth", self._qsize)
        self.stats.register_gauge("slo_level", lambda: self.slo.level if self.slo is not None else 0)
        self._compactor = None  # serve.mutable.CompactionManager attaches here
        # live-mutation gauges: 0 unless the retriever reports them (a mutable one)
        self.stats.register_gauge("delta_docs", lambda: self._mut_gauge("delta_docs"))
        self.stats.register_gauge("tombstones", lambda: self._mut_gauge("tombstones"))
        self.stats.register_gauge("delta_seq", lambda: self._mut_gauge("delta_seq"))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        if warmup:
            self.warmup()

    # ---- client side -----------------------------------------------------------

    def _default_params(self, retriever=None) -> Optional[DynamicParams]:
        """The dynamic point served when a request carries no override."""
        return self.default_params or getattr(retriever if retriever is not None else self.retriever, "defaults", None)

    def _cur_delta_seq(self) -> int:
        """Current delta sequence of the serving retriever (0 when immutable).
        Callers needing an un-torn (epoch, seq) pair read it under
        ``_retriever_lock``."""
        fn = getattr(self.retriever, "delta_seq", None)
        return int(fn()) if callable(fn) else 0

    def _mut_gauge(self, name: str) -> int:
        fn = getattr(self.retriever, "pressure", None)
        return int(fn().get(name, 0)) if callable(fn) else 0

    def _qsize(self) -> int:
        return self._q.qsize() + self._q_batch.qsize()

    def set_chaos(self, chaos: Optional[ChaosInjector]) -> None:
        """Attach (or detach, with None) a fault injector on a live engine."""
        self.chaos = chaos

    def search(self, request: SearchRequest) -> Future:
        """Future of ``SearchResponse`` for one request. Raises ``EngineShutdown``
        once the engine is shut down, ``AdmissionRejected`` when the tenant's
        quota is exhausted, ValueError for a per-request override the serving
        retriever cannot honour. A cache hit resolves synchronously; a deadline
        that expires before scoring resolves the future with ``DeadlineExceeded``."""
        t0 = time.monotonic()
        rid = request.request_id or f"req-{next(self._seq)}"
        if self._stop.is_set():
            self.stats.record_rejected()
            raise EngineShutdown(f"RetrievalEngine is shut down; request {rid} rejected", request_id=rid)
        # 1. quota (front door: an empty bucket costs the worker nothing)
        if self.admission is not None:
            try:
                self.admission.admit(request.tenant, rid)
            except AdmissionRejected:
                self.stats.record_quota_rejected()
                raise
            expiry = self.admission.expiry(request.deadline_ms, t0)
        else:
            expiry = None if request.deadline_ms is None else t0 + request.deadline_ms / 1e3
        # 2. per-request override validation
        params = request.params
        retr = self.retriever  # racy read is fine: validation only
        dynamic_ok = getattr(retr, "supports_dynamic", False)
        if params is not None:
            if not dynamic_ok:
                raise ValueError(
                    "per-request DynamicParams need a dynamic retriever "
                    "(core.lsp.make_dynamic_runner / repro_torch.api.Retriever); "
                    "this engine serves a fixed-config retriever"
                )
            scfg = getattr(retr, "static_cfg", None)
            if scfg is not None:
                params.validate_for(scfg)
        # 3. SLO degradation, resolved HERE so the cache key matches the point served
        eff, degraded, cap = params, False, 0
        if self.slo is not None:
            eff, degraded, cap = self.slo.resolve(params, self._default_params() or DynamicParams())
            if not dynamic_ok:
                # a fixed-config retriever can't take params; only the term cap applies
                eff, degraded = params, degraded and bool(cap)
        nq_cap = min(cap, self.nq_max) if cap else self.nq_max
        t, w = canonical_query(request.tids, request.weights, nq_cap)
        fut: Future = Future()
        key = None
        if self.cache is not None:
            # the key carries the dynamic-params bytes: distinct points NEVER
            # share an entry (an override changes θ/pruning/k, hence the result)
            point = eff or self._default_params()
            qk = (point.key_bytes() if point is not None else b"") + query_key(t, w)
            # probe under the flip lock: a swap cannot retire the epoch between
            # the read and the lookup, so a stale hit is impossible even in the
            # submit-vs-swap race window
            with self._retriever_lock:
                cache_key = (self._epoch, self._cur_delta_seq(), qk)
                hit = self.cache.get(cache_key)
            if hit is not None:
                self.stats.record((time.monotonic() - t0) * 1e3, cache_hit=True, degraded=hit.degraded)
                _try_set_result(fut, _response_from(hit, epoch=cache_key[0], cache_hit=True,
                                                    delta_seq=cache_key[1]))
                return fut
            self.stats.record_cache_miss()
            key = qk  # the worker re-keys with the epoch its batch is served at
        item = _Item(
            t0=t0, tids=t, ws=w, eff=eff, degraded=degraded, key=key, fut=fut,
            request_id=rid, expiry=expiry, lane=AdmissionController.lane(request.priority),
        )
        lane_q = self._q if item.lane == LANE_INTERACTIVE else self._q_batch
        while True:
            if self._stop.is_set():
                self.stats.record_rejected()
                raise EngineShutdown(f"RetrievalEngine is shut down; request {rid} rejected", request_id=rid)
            if item.expiry is not None and time.monotonic() > item.expiry:
                # backpressure held the caller past its own deadline: fail fast
                self.stats.record_deadline_expired()
                _try_set_exception(fut, DeadlineExceeded(
                    f"request {rid} deadline expired while blocked on backpressure",
                    request_id=rid, deadline_ms=request.deadline_ms,
                ))
                return fut
            try:
                lane_q.put(item, timeout=0.05)
                break
            except queue.Full:
                continue  # backpressure: hold the caller until the worker drains
        if self._stop.is_set():
            self._drain()  # lost the race with shutdown's drain; fail it ourselves
        if self.slo is not None:
            self.slo.observe(self._qsize())  # queue growth degrades at admission speed
        return fut

    def submit(self, tids: np.ndarray, ws: np.ndarray) -> Future:
        """Deprecated raw-array entry point: Future of (ids [k], scores [k]) for
        one sparse query at the engine's default params. A shim over
        ``search()``, kept for the JAX package's callers."""
        warnings.warn(
            "RetrievalEngine.submit(tids, ws) is deprecated; use "
            "search(SearchRequest(tids, weights)) -> Future[SearchResponse]",
            DeprecationWarning,
            stacklevel=2,
        )
        inner = self.search(SearchRequest(tids, ws))
        out: Future = Future()

        def _chain(f: Future) -> None:
            if f.cancelled():
                out.cancel()
                return
            exc = f.exception()
            if exc is not None:
                _try_set_exception(out, exc)
            else:
                r = f.result()
                _try_set_result(out, (r.doc_ids, r.scores))

        inner.add_done_callback(_chain)
        return out

    def warmup(self) -> None:
        """Run every ladder bucket once, so no live request pays a first-use
        cost (on CUDA, building and loading the kernels). Uses the retriever's
        own warmup hook when present, else pushes an empty padded batch through
        each shape."""
        self._warm(self.retriever)

    def _warm(self, retriever) -> None:
        device = _retriever_device(retriever)
        with on_device(device):
            if hasattr(retriever, "warmup"):
                retriever.warmup([(b.batch, b.nq) for b in self.ladder.shapes()])
                return
            for b in self.ladder.shapes():
                qb = make_query_batch([_EMPTY_QUERY] * b.batch, self.vocab, nq_max=b.nq, device=device)
                retriever(qb)

    # ---- live mutation ---------------------------------------------------------

    def _mutable_retriever(self, op: str):
        r = self.retriever
        if not callable(getattr(r, "add_docs", None)):
            raise RuntimeError(
                f"{op} needs a mutable retriever (serve.mutable.MutableRetrieverAdapter, "
                "e.g. via repro_torch.api.Retriever.mutable().serve()); this engine serves an "
                "immutable one — use swap_index for whole-index replacement"
            )
        return r

    def add_docs(self, docs) -> tuple[list[int], int]:
        """Ingest docs (each a ``(tids, weights)`` pair) into the live index.

        Returns (assigned external doc ids, new delta seq). The new docs are
        visible to every search admitted after this returns: the seq bump
        retires the cache namespace and stale entries are purged. Raises
        RuntimeError when the serving retriever is immutable."""
        r = self._mutable_retriever("add_docs")
        ids, seq = r.add_docs(docs)
        if self.cache is not None:
            self.cache.purge(lambda k: k[1] != seq)
        self.stats.record_adds(len(ids))
        comp = self._compactor
        if comp is not None:
            comp.notify()
        return ids, seq

    def delete_docs(self, ids) -> int:
        """Tombstone external doc ids in the live index; returns the new delta
        seq. A deleted doc never appears in a search admitted after this
        returns. KeyError (unknown or already-deleted id) reaches the caller
        before any state changes."""
        r = self._mutable_retriever("delete_docs")
        seq = r.delete_docs(ids)
        if self.cache is not None:
            self.cache.purge(lambda k: k[1] != seq)
        self.stats.record_deletes(len(list(ids)))
        comp = self._compactor
        if comp is not None:
            comp.notify()
        return seq

    # ---- index lifecycle -------------------------------------------------------

    @property
    def epoch(self) -> int:
        """Current index epoch (0 at start, +1 per completed swap)."""
        return self._epoch

    def swap_retriever(self, retriever: Callable[[QueryBatch], tuple], warm: bool = True) -> int:
        """Zero-downtime hot-swap to ``retriever``. Warmup (every ladder bucket)
        runs on the calling thread while the worker keeps serving on the old
        retriever; the flip itself is atomic between batches. In-flight batches
        complete on the retriever they started with; the epoch bump retires
        every cache entry of the old index. Returns the new epoch."""
        if self._stop.is_set():
            raise EngineShutdown("RetrievalEngine is shut down; swap rejected")
        t0 = time.monotonic()
        with self._swap_lock:
            if warm:
                self._warm(retriever)
            with self._retriever_lock:
                self.retriever = retriever
                self._epoch += 1
                epoch = self._epoch
            if self.cache is not None:
                self.cache.purge(lambda k: k[0] != epoch)
        self.stats.record_swap((time.monotonic() - t0) * 1e3)
        return epoch

    def swap_index(self, path_or_index, warm: bool = True) -> int:
        """Hot-swap to a new index: an ``LSPIndex``, a ``store.ShardedIndex``,
        or the path of a persisted directory of either format (``index.store``,
        the JAX package's too) read through ``load_index_auto`` onto the
        serving retriever's device. A sharded directory loads every shard of
        the set, so all shards flip together under the one epoch bump. Needs
        ``retriever_factory``; load, build and warm-up all happen on the
        calling thread, so a failing load or shard build raises HERE and the
        engine keeps serving on the old retriever. A factory that opens a
        directory itself (``takes_paths``: the process-group front end of
        ``serve/group.py``, whose ranks each load their own shard) is handed
        the path."""
        from repro_torch.index.store import load_index_auto

        if self.retriever_factory is None:
            raise RuntimeError("swap_index needs retriever_factory= at engine construction")
        takes_paths = getattr(self.retriever_factory, "takes_paths", False)
        if isinstance(path_or_index, (str, os.PathLike)) and not takes_paths:
            path_or_index = load_index_auto(os.fspath(path_or_index), mmap=True,
                                            device=_retriever_device(self.retriever))
        return self.swap_retriever(self.retriever_factory(path_or_index), warm=warm)

    def shutdown(self) -> None:
        """Idempotent. Stops the compactor (if attached) and the worker, then
        fails anything still queued."""
        comp = self._compactor
        if comp is not None:
            comp.stop()
        self._stop.set()
        self._thread.join(timeout=10)
        self._drain()  # submits that raced the worker's own exit drain

    # ---- engine thread ---------------------------------------------------------

    def _get_any(self, timeout: float) -> _Item:
        """Next item, interactive lane first: batch work is taken only when no
        interactive request is waiting at that instant (lane preemption)."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                return self._q.get_nowait()
            except queue.Empty:
                pass
            try:
                return self._q_batch.get_nowait()
            except queue.Empty:
                pass
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise queue.Empty
            try:
                # block briefly on the interactive lane so arrivals wake us; the
                # batch lane is re-polled each slice
                return self._q.get(timeout=min(remaining, 0.01))
            except queue.Empty:
                continue

    def _collect(self) -> list:
        items = []
        try:
            items.append(self._get_any(timeout=0.1))
        except queue.Empty:
            return items
        deadline = time.monotonic() + self.max_wait_ms / 1e3
        while len(items) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                items.append(self._get_any(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                items = self._collect()
                if items:
                    self._serve_batch(items)
        finally:
            # reached on clean shutdown AND when a programming error escapes
            # _serve_batch: mark the engine stopped and fail everything still
            # queued, so a dead worker can never strand blocked clients
            self._stop.set()
            self._drain()

    def _expire(self, items: list) -> list:
        """Fail (and drop) every item whose deadline passed while queued; these
        are never scored and never enter the latency window."""
        now = time.monotonic()
        live = []
        for it in items:
            if it.expiry is not None and now > it.expiry:
                self.stats.record_deadline_expired()
                _try_set_exception(it.fut, DeadlineExceeded(
                    f"request {it.request_id} deadline expired after {(now - it.t0) * 1e3:.1f} ms in queue",
                    request_id=it.request_id,
                ))
            else:
                live.append(it)
        return live

    def _serve_batch(self, items: list) -> None:
        items = self._expire(items)
        if not items:
            return
        # snapshot (retriever, epoch) atomically: the whole batch scores on one
        # index and its cache fills are keyed to that same index's epoch
        with self._retriever_lock:
            retriever, epoch = self.retriever, self._epoch
        dynamic = getattr(retriever, "supports_dynamic", False)
        dflt = self._default_params(retriever) or DynamicParams()
        bucket = self.ladder.select(len(items), max(len(it.tids) for it in items))
        queries = [(it.tids, it.ws) for it in items]
        while len(queries) < bucket.batch:
            queries.append(_EMPTY_QUERY)
        resolved = [it.eff or dflt for it in items]
        try:
            device = _retriever_device(retriever)
            with on_device(device):
                qb = make_query_batch(queries, self.vocab, nq_max=bucket.nq, device=device)
                if self.chaos is not None:
                    self.chaos.on_batch(len(items))  # may stall or raise: same isolation
                if dynamic:
                    # mixed per-request overrides ride one batch as per-row tensors
                    # (padding rows serve the defaults; their results are discarded)
                    row_params = resolved + [dflt] * (bucket.batch - len(items))
                    out = retriever(qb, row_params)
                else:
                    out = retriever(qb)
                # RetrievalResult (or any ids/scores-leading tuple) both unpack here
                ids = to_host(out[0])
                scores = to_host(out[1])
                theta = getattr(out, "theta", None)
                nsb = getattr(out, "n_superblocks_visited", None)
                nblk = getattr(out, "n_blocks_scored", None)
                shard_cand = getattr(out, "shard_candidates", None)
                theta = None if theta is None else to_host(theta)
                nsb = None if nsb is None else to_host(nsb)
                nblk = None if nblk is None else to_host(nblk)
                shard_cand = None if shard_cand is None else to_host(shard_cand)
            # the delta seq this batch was served at (0 for immutable retrievers):
            # fills key on it, so keys stay truthful
            served_seq = int(getattr(out, "delta_seq", 0) or 0)
            # rows whose tombstone overfetch clipped at k_max (0 for immutable
            # retrievers): a ServeStats counter, so short windows are seen
            saturated = int(getattr(out, "overfetch_saturated", 0) or 0)
        except _OPERATIONAL_ERRORS as exc:  # backend fault: fail this batch, keep serving
            for it in items:
                _try_set_exception(it.fut, exc)
            self.stats.record_failures(len(items))
            return
        except Exception as exc:  # programming error: fail the futures, then escalate
            for it in items:
                _try_set_exception(it.fut, exc)
            self.stats.record_failures(len(items))
            raise
        now = time.monotonic()
        for i, it in enumerate(items):
            k_i = min(resolved[i].k, ids.shape[1]) if dynamic else ids.shape[1]
            rec = _Record(
                ids=ids[i, :k_i].copy(),
                scores=scores[i, :k_i].copy(),
                theta=None if theta is None else float(theta[i]),
                nsb=None if nsb is None else int(nsb[i]),
                nblk=None if nblk is None else int(nblk[i]),
                params=resolved[i] if dynamic else it.eff,
                bucket=(bucket.batch, bucket.nq),
                shard_candidates=None if shard_cand is None else shard_cand[i].copy(),
                degraded=it.degraded,
            )
            if self.cache is not None and it.key is not None:
                # fill only while our epoch is still current (checked under the
                # flip lock): a batch that completes after a swap must not park
                # dead old-epoch rows in the LRU, where they would evict live ones
                with self._retriever_lock:
                    if epoch == self._epoch:
                        self.cache.put((epoch, served_seq, it.key), rec)
            lat_ms = (now - it.t0) * 1e3
            self.stats.record(lat_ms, degraded=it.degraded)
            if self.slo is not None:
                self.slo.record(lat_ms)
            # _response_from copies: a caller mutating ids/scores in place must
            # not corrupt what later hits are served from
            _try_set_result(it.fut, _response_from(rec, epoch=epoch, cache_hit=False, delta_seq=served_seq))
        if saturated:
            self.stats.record_overfetch_saturated(saturated)
        self.stats.record_batch(bucket)
        if self.slo is not None:
            self.slo.observe(self._qsize())  # served-latency view: recovery happens here

    def _drain(self) -> None:
        for lane_q in (self._q, self._q_batch):
            while True:
                try:
                    it = lane_q.get_nowait()
                except queue.Empty:
                    break
                _try_set_exception(it.fut, EngineShutdown(
                    f"RetrievalEngine shut down before serving request {it.request_id}",
                    request_id=it.request_id,
                ))
                self.stats.record_rejected()
