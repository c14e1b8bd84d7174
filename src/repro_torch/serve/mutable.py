"""Serving adapter over a MutableIndex + background compaction.

The port of the JAX package's ``serve/mutable.py``. ``MutableRetrieverAdapter``
speaks the dynamic retriever contract (``retriever(qb, dyn)`` returning a
RetrievalResult-like tuple, ``supports_dynamic``, ``warmup``/``n_traces``/
``static_cfg``/``defaults``/``vocab``/``device``), so it plugs into
``RetrievalEngine`` and ``Retriever.serve()`` unchanged. Per call it:

1. snapshots an immutable ``MutableView`` (main runtime + delta + tombstones
   + seq), so a compaction flip mid-batch cannot tear it;
2. runs the main backend **overfetched** to ``k_eff = k + T`` (T = live
   tombstone count, saturated at ``k_max``): dropping every tombstoned main
   hit still leaves >= k live main candidates;
3. brings the runtime's outputs to the host once (``.cpu().numpy()``),
   translates main internal ids to external ids and masks tombstoned docs to
   (-1, NEG);
4. scores the delta segment exactly on the host (``core.exact.score_delta_docs``)
   and merges both streams under the canonical (score desc, id asc) order
   with θ over the combined stream (``core.merge``);
5. stamps the result with the snapshot's ``delta_seq``: the engine keys its
   cache fill on the seq actually served.

With no tombstones and an empty delta the adapter is a bit-exact passthrough
of the immutable pipeline (ids translated, nothing else touched).

Saturation: when ``k + T > k_max`` the overfetch clips at ``k_max``, and a
query whose top-k is buried under more than ``k_max - k`` tombstoned main hits
can come up short until compaction folds the tombstones away. The adapter
serves the best window it has and counts every clipped row in
``MutableRetrievalResult.overfetch_saturated``; the engine folds that into
``ServeStats.overfetch_saturated``. Size ``CompactionManager``'s
``max_tombstones`` well below ``k_max - k``.

``CompactionManager`` owns the background rebuild loop: poked after every
mutation (and on a slow poll timer), it folds main + delta - tombstones into a
fresh generation on its own thread (entering the runtime's CUDA device
first: the current device is per thread), warms the new backend, commits, and
flips the engine's epoch through ``swap_retriever``, the same path an index
hot-swap takes. The build and the serving worker share the card: both launch
on the device's current stream and both hold the interpreter lock for their
host work.
"""

from __future__ import annotations

import threading
import time
from dataclasses import replace
from typing import NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.core.config import DynamicArgs, DynamicParams
from repro_torch.core.exact import score_delta_docs
from repro_torch.core.merge import merge_mutable_topk
from repro_torch.core.query import QueryBatch
from repro_torch.core.scoring import NEG
from repro_torch.device import on_device, to_host
from repro_torch.index.mutable import CompactionRaced, MutableIndex, MutableView


class MutableRetrievalResult(NamedTuple):
    """RetrievalResult plus mutation provenance: the delta seq the search was
    served at (what the engine keys its cache fill on). Host numpy arrays."""

    doc_ids: np.ndarray  # int32 [Q, k_max] external ids, -1 past k / invalid
    scores: np.ndarray  # float32 [Q, k_max]
    n_superblocks_visited: np.ndarray
    n_blocks_scored: np.ndarray
    theta: np.ndarray  # float32 [Q]: max(θ_main, k-th delta score)
    shard_candidates: Optional[np.ndarray] = None
    delta_seq: int = 0
    # rows whose tombstone overfetch clipped at k_max: each can come up short
    # of k until compaction (module doc, "Saturation")
    overfetch_saturated: int = 0


def _translate_ids(ids: np.ndarray, ext_ids: np.ndarray) -> np.ndarray:
    """Internal main ids -> external ids; invalid (-1) rows stay -1."""
    ids = np.asarray(ids)
    safe = np.clip(ids, 0, None).astype(np.int64)
    ext = ext_ids[safe] if ext_ids.size else safe
    return np.where(ids >= 0, ext, -1)


class MutableRetrieverAdapter:
    """Dynamic-retriever adapter over a ``MutableIndex``.

    The adapter's identity never changes across compactions: the engine keeps
    pointing at the same object while generations flip underneath it, which
    lets ``CompactionManager`` reuse ``swap_retriever`` for the epoch bump.
    """

    supports_dynamic = True

    def __init__(self, mutable: MutableIndex, runtime_factory):
        """``runtime_factory(LSPIndex) -> retriever`` builds the main backend
        (``api.Retriever``'s factory closure); every compaction reuses it for
        the fresh generation."""
        self._mutable = mutable
        self._runtime_factory = runtime_factory
        view = mutable.state()
        if view.runtime is None:
            if view.main is None:
                raise ValueError("MutableIndex has neither a runtime nor a main index to build one from")
            mutable.set_runtime(runtime_factory(view.main))
            view = mutable.state()
        rt = view.runtime
        self.static_cfg = getattr(rt, "static_cfg", None)
        self.defaults = getattr(rt, "defaults", None)
        self.vocab = mutable.vocab
        # where the engine builds each batch: the runtime's device
        self.device = getattr(rt, "device", mutable.device)

    # ---- retriever contract ----------------------------------------------------

    def __call__(self, qb: QueryBatch, dyn=None):
        view = self._mutable.state()
        runtime = view.runtime
        n_tomb = int(view.tombstones.size)
        n_delta = int(view.delta_ids.size)
        if n_tomb == 0 and n_delta == 0:
            out = runtime(qb, dyn)
            ids = _translate_ids(to_host(out.doc_ids), view.ext_ids).astype(np.int32)
            return MutableRetrievalResult(
                doc_ids=ids,
                scores=to_host(out.scores),
                n_superblocks_visited=to_host(out.n_superblocks_visited),
                n_blocks_scored=to_host(out.n_blocks_scored),
                theta=to_host(out.theta),
                shard_candidates=_shard_candidates(out),
                delta_seq=view.seq,
            )
        q = int(qb.tids.shape[0])
        rows = self._row_params(dyn, q)
        k_max = self.static_cfg.k_max if self.static_cfg is not None else max(p.k for p in rows)
        k_rows = np.asarray([p.k for p in rows], np.int64)
        # overfetch the main traversal so tombstone drops cannot starve the
        # window; it saturates at k_max, and clipped rows are counted
        n_saturated = sum(1 for p in rows if p.k + n_tomb > k_max)
        eff = [replace(p, k=min(p.k + n_tomb, k_max)) for p in rows]
        out = runtime(qb, eff)
        main_ids = _translate_ids(to_host(out.doc_ids), view.ext_ids)
        main_scores = to_host(out.scores).astype(np.float32, copy=True)
        if n_tomb:
            dead = np.isin(main_ids, view.tombstones)
            main_ids = np.where(dead, -1, main_ids)
            main_scores = np.where(dead, np.float32(NEG), main_scores)
        delta_ids = view.delta_ids.copy()
        if n_delta:
            delta_scores = score_delta_docs(to_host(qb.tids), to_host(qb.ws), view.delta_tids, view.delta_ws,
                                            self.vocab)
        else:
            delta_scores = np.zeros((q, 0), np.float32)
        if n_tomb and n_delta:
            dead_d = np.isin(delta_ids, view.tombstones)
            delta_ids = np.where(dead_d, -1, delta_ids)
            delta_scores = np.where(dead_d[None, :], np.float32(NEG), delta_scores)
        ids, scores, theta = merge_mutable_topk(
            main_ids, main_scores, delta_ids, delta_scores, k_rows, k_max, to_host(out.theta).astype(np.float32)
        )
        return MutableRetrievalResult(
            doc_ids=ids,
            scores=scores,
            n_superblocks_visited=to_host(out.n_superblocks_visited),
            n_blocks_scored=to_host(out.n_blocks_scored),
            theta=theta,
            shard_candidates=_shard_candidates(out),
            delta_seq=view.seq,
            overfetch_saturated=n_saturated,
        )

    def _row_params(self, dyn, q: int) -> list:
        d = self.defaults or DynamicParams(k=self.static_cfg.k_max if self.static_cfg is not None else DynamicParams.k)
        if dyn is None:
            return [d] * q
        if isinstance(dyn, DynamicParams):
            return [dyn] * q
        if isinstance(dyn, DynamicArgs):
            ks, mus = to_host(dyn.k), to_host(dyn.mu)
            etas, betas = to_host(dyn.eta), to_host(dyn.beta)
            return [
                DynamicParams(k=int(ks[i]), mu=float(mus[i]), eta=float(etas[i]), beta=float(betas[i]))
                for i in range(q)
            ]
        return list(dyn)

    def warmup(self, shapes) -> None:
        rt = self._mutable.state().runtime
        if hasattr(rt, "warmup"):
            rt.warmup(shapes)

    def n_traces(self) -> int:
        rt = self._mutable.state().runtime
        fn = getattr(rt, "n_traces", None)
        return int(fn()) if callable(fn) else 0

    # ---- mutation surface (what the engine delegates to) -----------------------

    def add_docs(self, docs: Sequence[tuple]) -> tuple[list[int], int]:
        return self._mutable.add_docs(docs)

    def delete_docs(self, ids: Sequence[int]) -> int:
        return self._mutable.delete_docs(ids)

    def delta_seq(self) -> int:
        return self._mutable.delta_seq()

    def pressure(self) -> dict:
        return self._mutable.pressure()

    def needs_compaction(self, max_delta_docs: int, max_tombstones: int) -> bool:
        return self._mutable.needs_compaction(max_delta_docs, max_tombstones)

    def compact(self, warm_shapes=None) -> MutableView:
        """Fold main + delta - tombstones into a fresh generation (build, backend
        and warm-up on the calling thread, under its device) and commit."""
        with on_device(self.device):
            return self._mutable.compact(self._runtime_factory, warm_shapes)


class CompactionManager:
    """Background compaction loop for an engine serving a MutableRetrieverAdapter.

    The engine pokes ``notify()`` after every mutation; a slow poll timer
    catches anything missed. When delta or tombstone pressure crosses the
    thresholds the loop rebuilds on its own thread (mutations and searches go
    on), then flips the engine's epoch through ``swap_retriever``: the new
    generation was warmed before the commit, so the flip is the atomic
    (retriever, epoch) bump plus the cache purge.

    Failures stay inside the serving fault boundary: ``CompactionRaced`` and
    the operational family (RuntimeError, which covers torch's CUDA errors,
    TimeoutError, OSError) are counted and the loop keeps running; programming
    errors escape.
    """

    def __init__(
        self,
        engine,
        adapter: MutableRetrieverAdapter,
        *,
        max_delta_docs: int = 1024,
        max_tombstones: int = 256,
        interval_s: float = 0.5,
    ):
        self.engine = engine
        self.adapter = adapter
        self.max_delta_docs = max_delta_docs
        self.max_tombstones = max_tombstones
        self.interval_s = interval_s
        self._poke = threading.Event()
        self._stop_evt = threading.Event()
        engine._compactor = self
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def notify(self) -> None:
        """Wake the loop (called by the engine after add_docs/delete_docs)."""
        self._poke.set()

    def compact_now(self) -> int:
        """Synchronous compaction + epoch flip; returns the new epoch."""
        t0 = time.monotonic()
        shapes = [(b.batch, b.nq) for b in self.engine.ladder.shapes()]
        self.adapter.compact(warm_shapes=shapes)
        epoch = self.engine.swap_retriever(self.adapter, warm=False)
        self.engine.stats.record_compaction((time.monotonic() - t0) * 1e3)
        return epoch

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            self._poke.wait(timeout=self.interval_s)
            self._poke.clear()
            if self._stop_evt.is_set():
                return
            if not self.adapter.needs_compaction(self.max_delta_docs, self.max_tombstones):
                continue
            try:
                self.compact_now()
            except CompactionRaced:
                continue  # a concurrent commit won; pressure re-evaluates next tick
            except (RuntimeError, TimeoutError, OSError):
                # operational fault (failed build/warm-up/swap, a CUDA error):
                # count it and keep serving on the current generation
                self.engine.stats.record_compaction_failed()

    def stop(self) -> None:
        self._stop_evt.set()
        self._poke.set()
        self._thread.join(timeout=10)
        if self.engine._compactor is self:
            self.engine._compactor = None


def _shard_candidates(out) -> Optional[np.ndarray]:
    sc = getattr(out, "shard_candidates", None)
    return None if sc is None else to_host(sc)
