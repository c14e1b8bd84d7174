"""CUDA graphs of the traversal's PyTorch op chains, one set per batch shape.

Eager, one traversal (``core.lsp.search_retrieve``) is four or five launches
of the hand-written kernels and some 260 small PyTorch ops around them, and
the host issues those ops more slowly than the card runs them. A
``GraphSet`` captures the op chains between the launches (the segments) once
for a batch shape and replays them. The launches stay eager: each goes
through its ``core.ops`` attribute on every call, on fresh copies of its
arguments, so a wrapper set on that attribute (a tracer that keeps the
arguments of the calls it sees) sees every call, and no later call
overwrites what it kept.

The segments are not written out twice: the traversal runs under
``ops.launches_through``, which hands each raw launch to the set, so a
captured chain is the eager one op for op.

A set's first call runs the traversal eagerly through the set's buffers
(``run_eager``), which records each launch's output, then captures; later
calls replay (``replay``):

  inputs    the query rows copied into static buffers, padded with the
            sentinel (tid = vocab, weight 0) to the set's width; the per-row
            (k, μ, η, β) through one pinned host buffer and one copy
  segments  graph 0; launch 0 on clones of its arguments, its output copied
            into graph 1's static input; graph 1; ...; the last graph
  outputs   fresh copies of the last graph's outputs, which a caller may
            keep across calls

The sets of one ``ShapeGraphs`` share one memory pool: their replays never
interleave, and each keeps alive what it reads across its own launches.
"""

from __future__ import annotations

import gc
import threading
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import ops
from repro_torch.core.config import DynamicArgs, DynamicParams
from repro_torch.core.query import QueryBatch


# One capture at a time in the process: a capture's device-wide synchronise and
# cache release would invalidate a capture under way on another thread.
_CAPTURING = threading.Lock()


def nq_bucket(nq: int) -> int:
    """The width a batch of ``nq`` term slots runs at: ``nq`` rounded up to
    a multiple of 8, at least 8 (``make_query_batch``'s own padding)."""
    return max(8, -(-nq // 8) * 8)


def graphs_engage(device: torch.device, impl: str) -> bool:
    """Graphs replace the eager traversal on CUDA through the kernels only:
    the plain versions are not what the port runs there, and "legacy"
    synchronises with the host (``repeat_interleave``)."""
    return device.type == "cuda" and impl in ("auto", "kernel")


class _Launch:
    """One raw launch of a set: the ``core.ops`` attribute it calls, its
    static output (the next segment's input) and, once captured, its
    arguments as the graph before it leaves them."""

    __slots__ = ("name", "out", "args")

    def __init__(self, name: str, out: torch.Tensor):
        self.name, self.out, self.args = name, out, None


class GraphSet:
    """``body(qb, d)`` at one batch shape (``q`` rows, ``nq`` term slots):
    static inputs, each launch's static output and, once captured, the
    graphs. ``constants`` holds the storage pointers of the tensors a launch
    may take as they are (the index's); every other tensor argument is
    cloned."""

    def __init__(self, body: Callable, q: int, nq: int, vocab: int, device: torch.device,
                 constants: frozenset):
        self.body, self.vocab, self.device, self.constants = body, vocab, device, constants
        self.qb = QueryBatch(torch.full((q, nq), vocab, dtype=torch.int32, device=device),
                             torch.zeros((q, nq), dtype=torch.float32, device=device), vocab)
        self._width = 0  # the columns a real term may occupy; the rest hold the sentinel
        # (k, μ, η, β) as rows of int32 words: k as itself, the rest as float32 bits
        self._host = torch.empty((4, q), dtype=torch.int32, pin_memory=device.type == "cuda")
        self._dyn = torch.empty((4, q), dtype=torch.int32, device=device)
        self.d = DynamicArgs(self._dyn[0], *(self._dyn[i].view(torch.float32) for i in (1, 2, 3)))
        self._copied = None  # event after the last copy out of the pinned buffer
        self._rows = ()  # the rows the device buffer holds
        self.launches: list[_Launch] = []
        self.graphs: list = []
        self.outputs = None

    def load(self, qb: QueryBatch, rows: Sequence[DynamicParams]) -> None:
        """The batch into the static inputs: one copy each for the query
        rows (plus a fill where the last batch reached further), one for the
        per-row parameters unless they are the last batch's."""
        tids, ws = self.qb.tids, self.qb.ws
        nq = qb.tids.shape[1]
        if nq == tids.shape[1]:
            tids.copy_(qb.tids)
            ws.copy_(qb.ws)
        else:
            tids[:, :nq].copy_(qb.tids)
            ws[:, :nq].copy_(qb.ws)
            if nq < self._width:
                tids[:, nq : self._width].fill_(self.vocab)
                ws[:, nq : self._width].zero_()
        self._width = nq
        rows = tuple(rows)
        if rows == self._rows:  # DynamicParams are frozen: the device holds these values already
            return
        if self._copied is not None:
            self._copied.synchronize()  # the previous batch's copy has read the pinned buffer
        host = self._host.numpy()
        host[0] = [p.k for p in rows]
        host[1:].view(np.float32)[:] = [[p.mu for p in rows], [p.eta for p in rows], [p.beta for p in rows]]
        self._dyn.copy_(self._host, non_blocking=True)
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record()
        self._rows = rows

    def _fresh(self, args) -> list:
        return [a.clone() if isinstance(a, torch.Tensor) and a.untyped_storage().data_ptr() not in self.constants
                else a for a in args]

    def run_eager(self):
        """The loaded batch through ``body`` eagerly: each launch on clones
        of its arguments, its output copied into its static buffer (made on
        the first call, which records the launches)."""
        n = 0

        def launch(name, *args):
            nonlocal n
            out = getattr(ops, name)(*self._fresh(args))
            if n == len(self.launches):
                self.launches.append(_Launch(name, torch.empty_like(out)))
            static = self.launches[n]
            if static.name != name or static.out.shape != out.shape or static.out.dtype != out.dtype:
                raise RuntimeError(f"launch {n} of the traversal changed: {static.name} -> {name}")
            static.out.copy_(out)
            n += 1
            return static.out

        with ops.launches_through(launch):
            return self.body(self.qb, self.d)

    def capture(self, pool) -> None:
        """Capture the segments on a side stream into ``pool``. Needs a
        ``run_eager`` before it, for the launches' static outputs; launches
        nothing."""
        graphs = [torch.cuda.CUDAGraph()]
        pending = iter(self.launches)

        def begin():
            graphs[-1].capture_begin(pool, capture_error_mode="thread_local")

        def launch(name, *args):
            static = next(pending, None)
            if static is None or static.name != name:
                raise RuntimeError(f"the traversal launched {name} where its eager run did not")
            graphs[-1].capture_end()
            static.args = args  # kept, so no later capture reuses their memory
            graphs.append(torch.cuda.CUDAGraph())
            begin()
            return static.out

        with _CAPTURING:
            torch.cuda.synchronize(self.device)
            # the capture cannot free cached blocks to make room for its pool: free them now
            torch.cuda.empty_cache()
            # a collection inside the capture could destroy another set's graphs, which
            # invalidates the capture (CUDA forbids freeing a graph while a stream captures)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.device(self.device), torch.cuda.stream(torch.cuda.Stream(self.device)), \
                        ops.launches_through(launch):
                    begin()
                    try:
                        out = self.body(self.qb, self.d)
                    finally:
                        graphs[-1].capture_end()
            finally:
                if collecting:
                    gc.enable()
            torch.cuda.synchronize(self.device)
        if next(pending, None) is not None:
            raise RuntimeError("the captured traversal made fewer launches than its eager run")
        self.graphs, self.outputs = graphs, out

    def replay(self):
        """The loaded batch through the graphs, on the current stream; the
        outputs are fresh tensors."""
        for graph, static in zip(self.graphs, self.launches):
            graph.replay()
            static.out.copy_(getattr(ops, static.name)(*self._fresh(static.args)))
        self.graphs[-1].replay()
        return type(self.outputs)(*(t.clone() if isinstance(t, torch.Tensor) else t for t in self.outputs))


class ShapeGraphs:
    """The graph sets of ``body`` over one index, made as batch shapes
    (Q, ``nq_bucket(nq)``) first arrive, on CUDA. Counts the calls that
    captured a set and those that replayed one."""

    def __init__(self, body: Callable, vocab: int, device: torch.device, constants: frozenset):
        self.body, self.vocab, self.device, self.constants = body, vocab, device, constants
        self.sets: dict[tuple[int, int], GraphSet] = {}
        self.captures = self.replays = 0
        self._pool = None
        self._lock = threading.Lock()  # the static buffers serve one call at a time

    def __call__(self, qb: QueryBatch, rows: Sequence[DynamicParams]):
        q, nq = qb.tids.shape
        key = (q, nq_bucket(nq))
        with self._lock, torch.cuda.device(self.device):
            gs = self.sets.get(key)
            if gs is not None:
                gs.load(qb, rows)
                self.replays += 1
                return gs.replay()
            gs = GraphSet(self.body, q, key[1], self.vocab, self.device, self.constants)
            gs.load(qb, rows)
            out = gs.run_eager()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            gs.capture(self._pool)
            self.sets[key] = gs
            self.captures += 1
            return out
