"""Mutable index generation: immutable main + append-only delta - tombstones.

The port of the JAX package's ``index/mutable.py``, with the same names and
the same host state. The paper's superblock index is built once and served
immutably; a live corpus needs adds and deletes that are visible at once.
``MutableIndex`` fronts three components:

* the **main generation**: an immutable port ``LSPIndex`` on its device,
  searched by the existing backends and untouched by mutations;
* an append-only **delta segment** of newly added docs with no superblock
  structure, scored exactly on the host (``core.exact.score_delta_docs``) and
  merged into the pruned main top-k under the canonical (score desc, id asc)
  order (``core.merge``);
* a **tombstone set** of deleted external doc ids, masked out of every
  canonical merge (a tombstoned doc never surfaces, main or delta).

The corpus CSR, ``ext_ids``, the delta segment and the tombstones are numpy
on the host, as in the JAX package. Background **compaction** folds main +
delta - tombstones into a fresh main generation (``index.builder.build_index``
over the live corpus, sorted by external id, on the index's device) and swaps
it in atomically; the delta suffix and tombstones accrued during the build
carry over, so mutations never wait for a rebuild.

External ids are the stable identity: monotonic, never reused. Internal main
ids are positions in the main corpus; ``ext_ids`` (strictly ascending) maps
them out. Ascending ``ext_ids`` plus delta ids greater than every main id
make the backend's internal-id-ascending tie-break the external ascending
tie-break.

Concurrency: all mutable state is private and accessed under ``self._lock``
(mutations, snapshots, commit); ``self._compact_lock`` serializes whole
compactions (snapshot -> build -> commit) without blocking mutations or reads.
Readers get an immutable ``MutableView`` snapshot: arrays in a published view
are never written again (the delta's buffers are copy-on-grow).
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.index.builder import IndexBuildConfig, build_index
from repro_torch.index.layout import LSPIndex, index_device


class CompactionRaced(RuntimeError):
    """A compaction commit lost the generation race (a newer commit landed
    between this plan's snapshot and its commit). Operational, not a bug:
    callers retry or skip; a RuntimeError keeps it inside the serving layer's
    operational-error family."""


def _canonical_doc(tids, ws, vocab: int) -> tuple[np.ndarray, np.ndarray]:
    """Canonical sparse doc: int32 tids ascending, float32 weights, duplicate
    term ids combined by sum (scoring is additive, so a duplicated tid adds
    the sum of its weights through every path)."""
    t = np.asarray(tids, np.int64).ravel()
    w = np.asarray(ws, np.float32).ravel()
    if t.shape != w.shape:
        raise ValueError(f"doc tids/ws length mismatch: {t.shape} vs {w.shape}")
    if t.size and (t.min() < 0 or t.max() >= vocab):
        raise ValueError(f"doc term ids out of range [0, {vocab})")
    if t.size == 0:
        return t.astype(np.int32), w
    ut, inv = np.unique(t, return_inverse=True)
    uw = np.zeros(ut.shape[0], np.float32)
    np.add.at(uw, inv, w)
    return ut.astype(np.int32), uw


class DeltaSegment:
    """Append-only padded store of delta docs (the raw CSR is kept for compaction).

    Padded arrays use the corpus-wide sentinel (tid == vocab, weight 0), so
    ``score_delta_docs`` needs no mask. Buffers grow copy-on-write (geometric
    capacity, width re-padded to a multiple of 8): rows of a published
    snapshot are never written again.
    """

    def __init__(self, vocab: int):
        self.vocab = vocab
        self._raw: list[tuple[np.ndarray, np.ndarray, int]] = []  # (tids, ws, ext_id)
        self._width = 8
        self._tids = np.full((0, 8), vocab, np.int32)
        self._ws = np.zeros((0, 8), np.float32)
        self._ids = np.zeros(0, np.int64)

    def __len__(self) -> int:
        return len(self._raw)

    def append(self, tids: np.ndarray, ws: np.ndarray, ext_id: int) -> None:
        t, w = _canonical_doc(tids, ws, self.vocab)
        self._raw.append((t, w, int(ext_id)))
        n = len(self._raw)
        width = max(self._width, max(8, -(-max(t.size, 1) // 8) * 8))
        if width > self._width or n > self._tids.shape[0]:
            cap = max(8, 2 * self._tids.shape[0], n)
            tids_new = np.full((cap, width), self.vocab, np.int32)
            ws_new = np.zeros((cap, width), np.float32)
            tids_new[: n - 1, : self._width] = self._tids[: n - 1]
            ws_new[: n - 1, : self._width] = self._ws[: n - 1]
            ids_new = np.zeros(cap, np.int64)
            ids_new[: n - 1] = self._ids[: n - 1]
            self._tids, self._ws, self._ids, self._width = tids_new, ws_new, ids_new, width
        self._tids[n - 1, : t.size] = t
        self._ws[n - 1, : t.size] = w
        self._ids[n - 1] = ext_id

    def snapshot(self, n: Optional[int] = None):
        """Immutable views of the first ``n`` docs: (tids [n, w], ws [n, w], ids [n])."""
        if n is None:
            n = len(self._raw)
        return self._tids[:n], self._ws[:n], self._ids[:n]

    def csr(self, lo: int = 0, hi: Optional[int] = None):
        """Raw (unpadded) CSR of docs[lo:hi] plus their external ids."""
        if hi is None:
            hi = len(self._raw)
        docs = self._raw[lo:hi]
        ptr = np.zeros(len(docs) + 1, np.int64)
        np.cumsum([t.size for t, _, _ in docs], out=ptr[1:])
        tids = (np.concatenate([t for t, _, _ in docs]) if docs else np.zeros(0, np.int64)).astype(np.int64)
        ws = (np.concatenate([w for _, w, _ in docs]) if docs else np.zeros(0, np.float32)).astype(np.float32)
        ids = np.asarray([i for _, _, i in docs], np.int64)
        return ptr, tids, ws, ids


class MutableView(NamedTuple):
    """Immutable snapshot of a MutableIndex: everything one search needs,
    captured atomically so a compaction flip mid-batch cannot tear it."""

    main: Optional[LSPIndex]
    runtime: object  # backend over `main` (opaque; may be None)
    ext_ids: np.ndarray  # int64 [n_main] internal -> external, strictly ascending
    delta_tids: np.ndarray  # int32 [D, nd] sentinel-padded
    delta_ws: np.ndarray  # float32 [D, nd]
    delta_ids: np.ndarray  # int64 [D] external ids, strictly ascending
    tombstones: np.ndarray  # int64 [T] sorted external ids
    seq: int  # delta sequence: bumps on every mutation AND compaction commit
    generation: int  # main-generation counter: bumps on compaction commit only
    n_live: int


class CompactionPlan(NamedTuple):
    """Snapshot taken by begin_compaction: the build's entire input, so
    build_compacted runs without the lock while mutations keep landing."""

    generation: int
    delta_mark: int  # delta prefix folded by this plan
    tombstones: frozenset  # external ids folded (dropped) by this plan
    main_ptr: np.ndarray
    main_tids: np.ndarray
    main_ws: np.ndarray
    main_ext_ids: np.ndarray
    delta_ptr: np.ndarray
    delta_tids: np.ndarray
    delta_ws: np.ndarray
    delta_ids: np.ndarray


class CompactedBuild(NamedTuple):
    """Output of build_compacted, handed unchanged to commit_compaction."""

    index: LSPIndex
    ext_ids: np.ndarray
    corpus_ptr: np.ndarray
    corpus_tids: np.ndarray
    corpus_ws: np.ndarray


def _live_rows(ptr: np.ndarray, tids: np.ndarray, ws: np.ndarray, live: np.ndarray):
    """The postings of the docs where ``live`` is set, in doc order."""
    keep = np.repeat(live, np.diff(ptr))
    return tids[keep], ws[keep]


def _live_csr(plan: CompactionPlan):
    """The plan's live docs (main + delta - tombstones) as one CSR, external-id
    ascending. Main ext ids ascend; delta ids ascend and all exceed the main
    range, so the concatenation is already strictly ascending. The JAX
    package walks every doc in a Python loop; the same arrays come from one
    posting mask per part here (seconds less at a million docs)."""
    dead = np.asarray(sorted(plan.tombstones), np.int64)

    def live_mask(ids):
        if dead.size == 0:
            return np.ones(ids.shape[0], bool)
        return ~np.isin(ids, dead)

    m_live = live_mask(plan.main_ext_ids)
    d_live = live_mask(plan.delta_ids)
    lengths = np.concatenate([np.diff(plan.main_ptr)[m_live], np.diff(plan.delta_ptr)[d_live]])
    ptr = np.zeros(lengths.shape[0] + 1, np.int64)
    np.cumsum(lengths, out=ptr[1:])
    m_tids, m_ws = _live_rows(plan.main_ptr, plan.main_tids, plan.main_ws, m_live)
    d_tids, d_ws = _live_rows(plan.delta_ptr, plan.delta_tids, plan.delta_ws, d_live)
    tids = np.concatenate([m_tids.astype(np.int64), d_tids.astype(np.int64)])
    ws = np.concatenate([m_ws.astype(np.float32), d_ws.astype(np.float32)])
    ext_ids = np.concatenate([plan.main_ext_ids[m_live], plan.delta_ids[d_live]]).astype(np.int64)
    return ptr, tids, ws, ext_ids


class MutableIndex:
    """Generation abstraction over a main ``LSPIndex`` + delta segment + tombstones.

    ``device`` is where compactions build the next main generation: the main
    generation's device when one is given, else CUDA unless named."""

    def __init__(
        self,
        main: Optional[LSPIndex],
        corpus_ptr: np.ndarray,
        corpus_tids: np.ndarray,
        corpus_ws: np.ndarray,
        vocab: int,
        build_cfg: IndexBuildConfig,
        *,
        ext_ids: Optional[np.ndarray] = None,
        runtime: object = None,
        device=None,
    ):
        n_main = len(corpus_ptr) - 1
        if ext_ids is None:
            ext_ids = np.arange(n_main, dtype=np.int64)
        ext_ids = np.asarray(ext_ids, np.int64)
        if ext_ids.shape[0] != n_main:
            raise ValueError(f"ext_ids has {ext_ids.shape[0]} entries for {n_main} docs")
        if n_main and np.any(np.diff(ext_ids) <= 0):
            raise ValueError("ext_ids must be strictly ascending (canonical tie-break)")
        self.vocab = vocab
        self.build_cfg = build_cfg
        self.device = resolve_device(index_device(main) if device is None and main is not None else device)
        self._lock = threading.RLock()
        self._compact_lock = threading.Lock()
        self._main = main
        self._runtime = runtime
        self._corpus_ptr = np.asarray(corpus_ptr, np.int64)
        self._corpus_tids = np.asarray(corpus_tids, np.int64)
        self._corpus_ws = np.asarray(corpus_ws, np.float32)
        self._ext_ids = ext_ids
        self._delta = DeltaSegment(vocab)
        self._tombstones: set[int] = set()
        self._live: set[int] = set(ext_ids.tolist())
        self._next_id = int(ext_ids[-1]) + 1 if n_main else 0
        self._seq = 0
        self._generation = 0
        self._view: Optional[MutableView] = None

    # ------------------------------------------------------------- constructors

    @classmethod
    def from_corpus(
        cls,
        doc_ptr: np.ndarray,
        tids: np.ndarray,
        ws: np.ndarray,
        vocab: int,
        cfg: IndexBuildConfig,
        *,
        runtime: object = None,
        build_main: bool = True,
        device=None,
    ) -> "MutableIndex":
        device = resolve_device(device)
        main = build_index(doc_ptr, tids, ws, vocab, cfg, device=device) if build_main else None
        return cls(main, doc_ptr, tids, ws, vocab, cfg, runtime=runtime, device=device)

    # ------------------------------------------------------------------ queries

    def state(self) -> MutableView:
        """Atomic snapshot; cached per seq/generation (search calls this per batch)."""
        with self._lock:
            v = self._view
            if v is not None and v.seq == self._seq and v.generation == self._generation:
                return v
            d_tids, d_ws, d_ids = self._delta.snapshot()
            v = MutableView(
                main=self._main,
                runtime=self._runtime,
                ext_ids=self._ext_ids,
                delta_tids=d_tids,
                delta_ws=d_ws,
                delta_ids=d_ids.copy(),
                tombstones=np.asarray(sorted(self._tombstones), np.int64),
                seq=self._seq,
                generation=self._generation,
                n_live=len(self._live),
            )
            self._view = v
            return v

    def delta_seq(self) -> int:
        with self._lock:
            return self._seq

    def pressure(self) -> dict:
        """Gauges for ServeStats and the compaction trigger."""
        with self._lock:
            return {
                "delta_docs": len(self._delta),
                "tombstones": len(self._tombstones),
                "delta_seq": self._seq,
                "generation": self._generation,
                "live_docs": len(self._live),
            }

    def needs_compaction(self, max_delta_docs: int, max_tombstones: int) -> bool:
        with self._lock:
            return len(self._delta) >= max_delta_docs or len(self._tombstones) >= max_tombstones

    # ---------------------------------------------------------------- mutations

    def add_docs(self, docs: Sequence[tuple]) -> tuple[list[int], int]:
        """Append docs (each a (tids, ws) pair) to the delta segment.

        Returns (assigned external ids, new delta seq). Ids are monotonic and
        never reused, so every delta id exceeds every main id."""
        canon = [_canonical_doc(t, w, self.vocab) for t, w in docs]
        with self._lock:
            ids = []
            for t, w in canon:
                ext = self._next_id
                self._next_id += 1
                self._delta.append(t, w, ext)
                self._live.add(ext)
                ids.append(ext)
            if ids:
                self._seq += 1
                self._view = None
            return ids, self._seq

    def delete_docs(self, ids: Sequence[int]) -> int:
        """Tombstone external ids. Raises KeyError on unknown or already-deleted
        ids (the caller's view of the corpus is wrong). Returns the new delta seq."""
        with self._lock:
            ids = [int(i) for i in ids]
            for i in ids:
                if i not in self._live:
                    raise KeyError(f"doc id {i} is not live (unknown or already deleted)")
            for i in ids:
                self._live.discard(i)
                self._tombstones.add(i)
            if ids:
                self._seq += 1
                self._view = None
            return self._seq

    def set_runtime(self, runtime: object) -> None:
        with self._lock:
            self._runtime = runtime
            self._view = None

    # --------------------------------------------------------------- compaction

    def begin_compaction(self) -> CompactionPlan:
        """Snapshot the build input under the lock (references to immutable
        arrays + a copy of the delta prefix); the build itself runs lock-free."""
        with self._lock:
            mark = len(self._delta)
            d_ptr, d_tids, d_ws, d_ids = self._delta.csr(0, mark)
            return CompactionPlan(
                generation=self._generation,
                delta_mark=mark,
                tombstones=frozenset(self._tombstones),
                main_ptr=self._corpus_ptr,
                main_tids=self._corpus_tids,
                main_ws=self._corpus_ws,
                main_ext_ids=self._ext_ids,
                delta_ptr=d_ptr,
                delta_tids=d_tids,
                delta_ws=d_ws,
                delta_ids=d_ids,
            )

    def build_compacted(self, plan: CompactionPlan) -> CompactedBuild:
        """Rebuild the live corpus (main + delta - tombstones, external-id
        ascending) into a fresh main generation on ``self.device``: a function
        of the plan and of the build's document order."""
        ptr, tids, ws, ext_ids = _live_csr(plan)
        index = build_index(ptr, tids, ws, self.vocab, self.build_cfg, device=self.device)
        return CompactedBuild(index, ext_ids, ptr, tids, ws)

    def commit_compaction(self, plan: CompactionPlan, built: CompactedBuild, runtime: object = None) -> MutableView:
        """Flip to the new generation atomically: the folded delta prefix drops
        off, the suffix accrued during the build carries over, folded
        tombstones are dropped (the new main omits those docs) and tombstones
        accrued during the build keep masking. Raises CompactionRaced if a
        newer commit landed first."""
        with self._lock:
            if self._generation != plan.generation:
                raise CompactionRaced(
                    f"compaction plan for generation {plan.generation} is stale "
                    f"(current generation {self._generation})"
                )
            suffix_ptr, suffix_tids, suffix_ws, suffix_ids = self._delta.csr(plan.delta_mark)
            self._main = built.index
            self._runtime = runtime
            self._corpus_ptr = built.corpus_ptr
            self._corpus_tids = built.corpus_tids
            self._corpus_ws = built.corpus_ws
            self._ext_ids = built.ext_ids
            delta = DeltaSegment(self.vocab)
            for j in range(len(suffix_ids)):
                lo, hi = suffix_ptr[j], suffix_ptr[j + 1]
                delta.append(suffix_tids[lo:hi], suffix_ws[lo:hi], int(suffix_ids[j]))
            self._delta = delta
            self._tombstones -= set(plan.tombstones)
            self._generation += 1
            self._seq += 1
            self._view = None
            return self.state()

    def compact(self, runtime_factory=None, warm_shapes=None) -> MutableView:
        """Whole compaction under ``_compact_lock`` (serialized with other
        compactions only; mutations and searches go on throughout): snapshot,
        lock-free rebuild, optional backend build + warm-up, atomic commit."""
        with self._compact_lock:
            plan = self.begin_compaction()
            built = self.build_compacted(plan)
            runtime = runtime_factory(built.index) if runtime_factory is not None else None
            if runtime is not None and warm_shapes:
                runtime.warmup(warm_shapes)
            return self.commit_compaction(plan, built, runtime)

    # -------------------------------------------------------------- persistence

    def logical_corpus(self):
        """The live corpus as (ptr, tids, ws, ext_ids), external-id ascending:
        what a from-scratch rebuild of "the same logical corpus" means."""
        return _live_csr(self.begin_compaction())

    def persistable_state(self) -> dict:
        """Arrays + counters for the store's mutable manifest, taken atomically;
        the main index tree is persisted separately."""
        with self._lock:
            if self._main is None:
                raise ValueError(
                    "MutableIndex has no materialized main generation (promoted from a "
                    "sharded index?) — compact() first to build one"
                )
            d_ptr, d_tids, d_ws, d_ids = self._delta.csr()
            return {
                "main": self._main,
                "arrays": {
                    "corpus_ptr": self._corpus_ptr,
                    "corpus_tids": self._corpus_tids,
                    "corpus_ws": self._corpus_ws,
                    "ext_ids": self._ext_ids,
                    "delta_ptr": d_ptr,
                    "delta_tids": d_tids,
                    "delta_ws": d_ws,
                    "delta_ids": d_ids,
                    "tombstones": np.asarray(sorted(self._tombstones), np.int64),
                },
                "meta": {
                    "vocab": self.vocab,
                    "next_id": self._next_id,
                    "seq": self._seq,
                    "generation": self._generation,
                },
            }

    @classmethod
    def restore(
        cls,
        main: LSPIndex,
        arrays: dict,
        meta: dict,
        build_cfg: IndexBuildConfig,
        *,
        runtime: object = None,
        device=None,
    ) -> "MutableIndex":
        mi = cls(
            main,
            arrays["corpus_ptr"],
            arrays["corpus_tids"],
            arrays["corpus_ws"],
            int(meta["vocab"]),
            build_cfg,
            ext_ids=arrays["ext_ids"],
            runtime=runtime,
            device=device,
        )
        with mi._lock:
            d_ptr, d_ids = arrays["delta_ptr"], arrays["delta_ids"]
            for j in range(len(d_ids)):
                lo, hi = int(d_ptr[j]), int(d_ptr[j + 1])
                ext = int(d_ids[j])
                mi._delta.append(arrays["delta_tids"][lo:hi], arrays["delta_ws"][lo:hi], ext)
                mi._live.add(ext)
            for t in arrays["tombstones"]:
                t = int(t)
                mi._tombstones.add(t)
                mi._live.discard(t)
            mi._next_id = int(meta["next_id"])
            mi._seq = int(meta["seq"])
            mi._generation = int(meta["generation"])
            mi._view = None
        return mi


def corpus_from_index(index: LSPIndex) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reconstruct a CSR corpus from a built index's forward docs (dequantized).

    The promotion path of an index loaded without its source corpus: weights
    come back as ``q * scale`` (the 8-bit dequantization), so the recovered
    corpus is the quantized logical corpus, exact for every later search and
    rebuild over it but not bit-equal to the original floats. Docs come back
    in external (original) id order. The JAX package walks every doc in a
    Python loop; one gather of the rows in doc order and one mask of the
    sentinel slots give the same arrays here.
    """
    fw_tids = index.docs_fwd.tids.cpu().numpy()
    fw_ws = index.docs_fwd.ws.cpu().numpy()
    remap = index.doc_remap.cpu().numpy()
    scale = float(index.docs_fwd.scale)
    pos_of = np.full(index.n_docs + 1, -1, np.int64)
    pos_of[remap] = np.arange(remap.shape[0])
    rows = pos_of[: index.n_docs]
    t = fw_tids[rows]  # [n_docs, t_max] in doc order
    valid = t < index.vocab
    ptr = np.zeros(index.n_docs + 1, np.int64)
    np.cumsum(valid.sum(axis=1), out=ptr[1:])
    tids = t[valid].astype(np.int64)
    ws = fw_ws[rows][valid].astype(np.float32) * np.float32(scale)
    return ptr, tids, ws
